"""The visual engine (``VisualScorer``): uint8 face-crop clips ``(T, S, S, 3)``.

Sizes are frame counts. A clip is a seeded moving pattern: a base colour,
a drifting sinusoidal grating of its own frequency, direction and
amplitude, and noise of its own level, so that clips differ in content and
the scores of a batch spread.
"""
from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import torch

from bench_port.engines._common import build_scorer, host, seeded
from bench_port.reference import heads as ref_heads
from bench_port.reference import xception as ref_xception

REF_BLOCK = 100  # frames per reference block
CALIBRATION_CLIPS = 16
TEXTURE = 40.0  # cycles per image of the fine grating, at most
NOISE = 0.08  # the noise's standard deviation at its level's midpoint, of full scale


def build(cfg: dict, bundle, device, overrides=None):
    return build_scorer(cfg, bundle, device, overrides)


def make_clips(cfg: dict, sizes: Sequence[int], seed: int, device) -> List[np.ndarray]:
    """One uint8 clip ``(T, S, S, 3)`` per size, from ``seed`` on ``device``:
    a base colour, two drifting gratings (one coarse, one fine, each of its
    own frequency, direction and amplitude) and noise of its own level."""
    g = seeded(seed, device)
    S = cfg["image_size"]
    par = torch.rand((len(sizes), 16), generator=g, device=device)
    yy, xx = torch.meshgrid(torch.arange(S, device=device) / S,
                            torch.arange(S, device=device) / S, indexing="ij")
    out = []
    for c, T in enumerate(sizes):
        p = par[c]
        t = torch.arange(T, device=device, dtype=torch.float32)[:, None, None]
        x = (0.2 + 0.6 * p[0:3]).expand(T, S, S, 3)
        for j, top in ((3, 6.0), (8, TEXTURE)):
            fx, fy = top * (2 * p[j] - 1), top * (2 * p[j + 1] - 1)
            wave = torch.sin(2 * math.pi * (fx * xx + fy * yy + (0.4 * p[j + 2] - 0.2) * t)
                             + 6.3 * p[j + 3])
            x = x + (0.05 + 0.2 * p[j + 4]) * wave[..., None]
        x = x + NOISE * (0.2 + p[13]) * torch.randn((T, S, S, 3), generator=g, device=device)
        out.append(host((x.clamp(0, 1) * 255).round().to(torch.uint8)))
    return out


def calibration(cfg: dict, seed: int, device) -> torch.Tensor:
    """Images the weight maker measures BN statistics on and places the head
    with: 4 frames of each of 16 seeded clips, in clip order, fp32 NHWC on
    ``device``."""
    clips = make_clips(cfg, [4] * CALIBRATION_CLIPS, seed, device)
    return torch.from_numpy(np.concatenate(clips)).to(device).float() / 255.0


def bulk_args(clips: Sequence[np.ndarray]) -> tuple:
    """A client's batch as the serve CLI collates it: the clips zero-padded
    to the longest, with their lengths."""
    lengths = [len(c) for c in clips]
    frames = np.zeros((len(clips), max(lengths)) + clips[0].shape[1:], np.uint8)
    for i, c in enumerate(clips):
        frames[i, :len(c)] = c
    return frames, np.asarray(lengths, np.int32)


def scored_clips(clips: Sequence[np.ndarray]) -> List[np.ndarray]:
    """What the program's answer for each row of :func:`bulk_args` means: the
    clip alone (the padding is masked by its length)."""
    return list(clips)


def bulk_call(scorer, args: tuple) -> np.ndarray:
    return scorer.score(*args)


def device_inputs(scorer, args: tuple):
    """What ``score`` hands its device side, on the device: the frames padded
    to the time bucket, and the lengths."""
    from multimodal_deepfake_detection_tpu_torch.data.collate import bucket_length

    frames, lengths = args
    B, T = frames.shape[:2]
    Tb = bucket_length(T, scorer.buckets)
    if Tb > T:
        frames = np.concatenate([frames, np.zeros((B, Tb - T) + frames.shape[2:], np.uint8)], 1)
    return (torch.from_numpy(frames).to(scorer.device),
            torch.from_numpy(np.asarray(lengths)).to(scorer.device))


def images(scorer, dev: tuple) -> torch.Tensor:
    """The backbone's input images of a call, on the device."""
    return scorer._u8_to_x(dev[0])


def call_shape(scorer, args: tuple) -> dict:
    """Rows and steps the device computes for one call of ``args``."""
    from multimodal_deepfake_detection_tpu_torch.data.collate import bucket_length

    B, T = args[0].shape[:2]
    return {"clips": B, "steps": bucket_length(T, scorer.buckets)}


def reference(cfg: dict, weights: dict, clips: Sequence[np.ndarray], device,
              dtype=torch.float32) -> np.ndarray:
    """Fake probabilities of each clip scored alone (its frames only), in
    fp32; with ``dtype`` bf16 the check's gauge: the backbone with each BN
    folded into its conv in fp32, then everything but ArcFace in bf16.
    Returned as fp64."""
    out = []
    for clip in clips:
        x = torch.from_numpy(clip).to(device)
        feats = ref_xception.features_blocked(weights, cfg, x, REF_BLOCK,
                                              lambda u8: (u8.float() / 255.0).to(dtype),
                                              folded=dtype != torch.float32)
        emb = ref_heads.lstm_last(weights, feats[None], torch.tensor([len(clip)], device=device))
        out.append(ref_heads.arcface_fake_prob(weights, emb, cfg["arcface_s"]).float())
    return host(torch.cat(out)).astype(np.float64)
