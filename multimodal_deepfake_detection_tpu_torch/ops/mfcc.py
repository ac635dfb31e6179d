"""MFCC frontend: waveform ``(..., samples)`` -> ``(..., frames, n_mfcc)``.

Counterpart of ``multimodal_deepfake_detection_tpu/ops/mfcc.py``, librosa's
``feature.mfcc`` as tensor math:

    center-pad (reflect) -> frame -> periodic Hann window -> rFFT power
    -> slaney mel filterbank (area-normalised) -> power_to_db (ref 1,
    amin 1e-10, top_db 80) -> orthonormal DCT-II -> first n_mfcc

The mel filterbank and the DCT are numpy constants (copies of the JAX
module's, which the port does not import); the rest is ``torch.fft.rfft``
and two matmuls. Everything computes in fp32 whatever the caller's compute
dtype; on the card in IEEE fp32 (:func:`mfcc` switches TF32 off around its
matmuls and restores the setting after).
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core.precision import ieee_fp32


# the slaney mel scale: linear below 1 kHz, log above
_F_SP = 200.0 / 3
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = math.log(6.4) / 27.0


def hz_to_mel(f):
    f = np.asarray(f, np.float64)
    return np.where(f >= _MIN_LOG_HZ,
                    _MIN_LOG_MEL + np.log(np.maximum(f, 1e-10) / _MIN_LOG_HZ) / _LOGSTEP,
                    f / _F_SP)


def mel_to_hz(m):
    m = np.asarray(m, np.float64)
    return np.where(m >= _MIN_LOG_MEL, _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL)),
                    _F_SP * m)


@lru_cache(maxsize=8)
def mel_filterbank(sr: int, n_fft: int, n_mels: int = 128) -> np.ndarray:
    """``(n_mels, 1 + n_fft//2)`` slaney-normalised triangular filters from 0
    Hz to ``sr / 2`` (``librosa.filters.mel``), fp32."""
    fft_freqs = np.linspace(0, sr / 2.0, 1 + n_fft // 2)
    mel_pts = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(sr / 2.0), n_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_pts[2 : n_mels + 2] - mel_pts[:n_mels])  # slaney area normalisation
    return (weights * enorm[:, None]).astype(np.float32)


@lru_cache(maxsize=8)
def dct_matrix(n_mfcc: int, n_mels: int) -> np.ndarray:
    """``(n_mfcc, n_mels)`` orthonormal DCT-II (``scipy.fft.dct(type=2, norm='ortho')``)."""
    n = np.arange(n_mels)
    k = np.arange(n_mfcc)[:, None]
    mat = np.cos(np.pi * k * (2 * n + 1) / (2 * n_mels)) * math.sqrt(2.0 / n_mels)
    mat[0] *= 1.0 / math.sqrt(2.0)
    return mat.astype(np.float32)


def frame_signal(y: torch.Tensor, n_fft: int, hop: int, *, center: bool = True) -> torch.Tensor:
    """``(..., samples)`` -> ``(..., frames, n_fft)`` with librosa's reflect centring."""
    if center:
        lead = y.shape[:-1]
        y = F.pad(y.reshape(-1, 1, y.shape[-1]), (n_fft // 2, n_fft // 2), mode="reflect")
        y = y.reshape(lead + y.shape[-1:])
    return y.unfold(-1, n_fft, hop)


def power_to_db(S: torch.Tensor, *, amin: float = 1e-10, top_db: float = 80.0) -> torch.Tensor:
    """``10 log10(max(S, amin))``, floored at ``top_db`` under the max of each
    spectrogram, taken over the trailing two axes (frames x mels), padding
    frames included."""
    log_spec = 10.0 * torch.log10(torch.clamp_min(S, amin))
    return torch.maximum(log_spec, log_spec.amax(dim=(-2, -1), keepdim=True) - top_db)


def mfcc_constants(device, *, sr: int = 16000, n_mfcc: int = 13, n_fft: int = 400,
                   n_mels: int = 128) -> tuple:
    """:func:`mfcc`'s constants on ``device``: the periodic Hann window, the
    mel filterbank and the DCT, fp32. A scorer makes them once, so that an
    exported program holds them as constants of its own device rather than
    host arrays it copies each call."""
    window = np.hanning(n_fft + 1)[:-1].astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in
                 (window, mel_filterbank(sr, n_fft, n_mels), dct_matrix(n_mfcc, n_mels)))


def mfcc(y: torch.Tensor, *, sr: int = 16000, n_mfcc: int = 13, n_fft: int = 400,
         hop_length: int = 160, n_mels: int = 128, center: bool = True,
         constants: Optional[tuple] = None) -> torch.Tensor:
    """Waveform ``(..., samples)`` -> fp32 MFCC ``(..., frames, n_mfcc)``,
    ``librosa.feature.mfcc(...).T``. ``center=False`` skips the reflect
    pre-pad, for callers that centre on the host (the bucketed serving path).
    ``constants``: :func:`mfcc_constants` of these settings on y's device
    (made here when None)."""
    if constants is None:
        constants = mfcc_constants(y.device, sr=sr, n_mfcc=n_mfcc, n_fft=n_fft, n_mels=n_mels)
    window, mel, dct = constants
    with ieee_fp32():
        frames = frame_signal(y.float(), n_fft, hop_length, center=center)
        spec = torch.fft.rfft(frames * window, n=n_fft, dim=-1)
        db = power_to_db(spec.abs() ** 2 @ mel.T)
        return db @ dct.T
