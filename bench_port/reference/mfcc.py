"""MFCC as ``librosa.feature.mfcc`` computes it, fp32, one clip at a time.

A frozen copy of the arithmetic: reflect centring, periodic Hann window,
rFFT power, slaney mel filterbank (area-normalised), ``power_to_db`` (ref 1,
amin 1e-10, top_db 80 under the clip's max), orthonormal DCT-II, the first
``n_mfcc`` coefficients.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

_F_SP = 200.0 / 3
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = math.log(6.4) / 27.0


def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    return np.where(f >= _MIN_LOG_HZ,
                    _MIN_LOG_MEL + np.log(np.maximum(f, 1e-10) / _MIN_LOG_HZ) / _LOGSTEP,
                    f / _F_SP)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    return np.where(m >= _MIN_LOG_MEL, _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL)),
                    _F_SP * m)


def mel_filterbank(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    fft_freqs = np.linspace(0, sr / 2.0, 1 + n_fft // 2)
    mel_pts = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(sr / 2.0), n_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_pts[2: n_mels + 2] - mel_pts[:n_mels])
    return (weights * enorm[:, None]).astype(np.float32)


def dct_matrix(n_mfcc: int, n_mels: int) -> np.ndarray:
    n = np.arange(n_mels)
    k = np.arange(n_mfcc)[:, None]
    mat = np.cos(np.pi * k * (2 * n + 1) / (2 * n_mels)) * math.sqrt(2.0 / n_mels)
    mat[0] *= 1.0 / math.sqrt(2.0)
    return mat.astype(np.float32)


def mfcc(y: torch.Tensor, cfg: dict) -> torch.Tensor:
    """One waveform ``(L,)`` -> ``(1 + L // hop, n_mfcc)``."""
    n_fft, hop = cfg["n_fft"], cfg["hop_length"]
    window = torch.from_numpy(np.hanning(n_fft + 1)[:-1].astype(np.float32)).to(y.device)
    mel = torch.from_numpy(mel_filterbank(cfg["sample_rate"], n_fft, cfg["n_mels"])).to(y.device)
    dct = torch.from_numpy(dct_matrix(cfg["n_mfcc"], cfg["n_mels"])).to(y.device)
    y = F.pad(y[None, None].float(), (n_fft // 2, n_fft // 2), mode="reflect")[0, 0]
    frames = y.unfold(0, n_fft, hop)
    power = torch.fft.rfft(frames * window, n=n_fft, dim=-1).abs() ** 2
    db = 10.0 * torch.log10(torch.clamp_min(power @ mel.T, 1e-10))
    db = torch.maximum(db, db.max() - 80.0)
    return db @ dct.T


def images(coeffs: torch.Tensor, size: int) -> torch.Tensor:
    """MFCC ``(T, n)`` -> ``(T, size, size, 3)``: each step an ``n x 1``
    image, three channels alike, resized bilinearly (half-pixel centres, no
    antialiasing)."""
    T, n = coeffs.shape
    x = coeffs.reshape(T, 1, n, 1).expand(T, 3, n, 1)
    x = F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False,
                      antialias=False)
    return x.permute(0, 2, 3, 1)
