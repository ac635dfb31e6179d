"""The audio engine (``AudioScorer``): 16 kHz float32 waveforms ``(L,)``.

Sizes are sample counts. A clip is seeded: three tones of their own pitch
(80 Hz to 4 kHz), amplitude and tremolo, over noise of its own level,
under a gain of its own, so that clips differ in content and the scores of
a batch spread.
"""
from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import torch

from bench_port.engines._common import build_scorer, host, seeded
from bench_port.reference import heads as ref_heads
from bench_port.reference import mfcc as ref_mfcc
from bench_port.reference import xception as ref_xception

REF_BLOCK = 1024  # MFCC images per reference block
CALIBRATION_CLIPS = 8


def build(cfg: dict, bundle, device, overrides=None):
    return build_scorer(cfg, bundle, device, overrides)


def make_clips(cfg: dict, sizes: Sequence[int], seed: int, device) -> List[np.ndarray]:
    """One float32 waveform ``(L,)`` per size, from ``seed`` on ``device``."""
    g = seeded(seed, device)
    sr = cfg["sample_rate"]
    par = torch.rand((len(sizes), 14), generator=g, device=device)
    out = []
    for c, L in enumerate(sizes):
        p = par[c]
        t = torch.arange(L, device=device, dtype=torch.float32) / sr
        y = (0.02 + 0.2 * p[12]) * torch.randn(L, generator=g, device=device)
        for k in range(3):
            pitch = 80.0 * (50.0 ** p[k])  # 80 Hz to 4 kHz, log-uniform
            trem = 1 + 0.8 * torch.sin(2 * math.pi * (0.5 + 6 * p[3 + k]) * t + 6.3 * p[6 + k])
            y = y + p[9 + k] * trem * torch.sin(2 * math.pi * pitch * t)
        out.append(host((0.05 + 0.45 * p[13]) * y / y.abs().max()))
    return out


def calibration(cfg: dict, seed: int, device) -> torch.Tensor:
    """Images the weight maker measures BN statistics on: the MFCC images of
    8 seeded clips of 0.25 s (26 steps each, in clip order), fp32 NHWC on
    ``device``."""
    clips = make_clips(cfg, [cfg["sample_rate"] // 4] * CALIBRATION_CLIPS, seed, device)
    return torch.cat([ref_mfcc.images(ref_mfcc.mfcc(torch.from_numpy(c).to(device), cfg),
                                      cfg["image_size"]) for c in clips])


def bulk_args(clips: Sequence[np.ndarray]) -> tuple:
    """A client's batch: the waveforms zero-padded to the longest, with each
    clip's sample length, so that each row scores as that clip alone
    (``AudioScorer.score``'s ``sample_lengths``)."""
    L = max(len(c) for c in clips)
    waves = np.stack([np.pad(np.asarray(c, np.float32), (0, L - len(c))) for c in clips])
    return waves, None, np.array([len(c) for c in clips], np.int64)


def scored_clips(clips: Sequence[np.ndarray]) -> List[np.ndarray]:
    """What the program's answer for each row of :func:`bulk_args` means: the
    clip alone."""
    return list(clips)


def bulk_call(scorer, args: tuple) -> np.ndarray:
    return scorer.score(*args)


def device_inputs(scorer, args: tuple):
    """What ``score`` hands its device side, on the device: the waveforms as
    the host side prepared them, the frame lengths, and whether the device
    centres."""
    waves, frame_lengths, centered = scorer._prepare(*args)
    return (torch.from_numpy(np.ascontiguousarray(waves, np.float32)).to(scorer.device),
            torch.from_numpy(np.asarray(frame_lengths)).to(scorer.device), centered)


def images(scorer, dev: tuple) -> torch.Tensor:
    """The MFCC frontend: waveforms -> the backbone's 64 x 64 images."""
    return scorer._images(dev[0], dev[2])[0]


def call_shape(scorer, args: tuple) -> dict:
    """Rows and steps (MFCC frames) the device computes for one call."""
    from multimodal_deepfake_detection_tpu_torch.data.collate import bucket_length

    B, L = args[0].shape[:2]
    Lb = bucket_length(L, scorer.sample_buckets)
    return {"clips": B, "steps": Lb // scorer.mfcc_kw["hop_length"] + 1}


def reference(cfg: dict, weights: dict, clips: Sequence[np.ndarray], device,
              dtype=torch.float32) -> np.ndarray:
    """Fake probabilities of each clip scored alone, in fp32; with ``dtype``
    bf16 the check's gauge: the MFCC in fp32, the backbone with each BN
    folded into its conv in fp32, then the rest in bf16 but the sigmoid.
    The backbone runs clip by clip; the LSTM and head over all the clips
    at once, each row read at its own last frame (rows do not mix).
    Returned as fp64."""
    feats = []
    for clip in clips:
        coeffs = ref_mfcc.mfcc(torch.from_numpy(clip).to(device), cfg)
        imgs = ref_mfcc.images(coeffs, cfg["image_size"]).to(dtype)
        feats.append(ref_xception.features_blocked(weights, cfg, imgs, REF_BLOCK,
                                                   folded=dtype != torch.float32))
    lengths = torch.tensor([f.shape[0] for f in feats], device=device)
    stack = torch.nn.utils.rnn.pad_sequence(feats, batch_first=True)
    emb = ref_heads.lstm_last(weights, stack, lengths)
    return host(ref_heads.mlp_fake_prob(weights, emb).double())
