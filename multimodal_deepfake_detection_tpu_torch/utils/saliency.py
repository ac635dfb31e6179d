"""Input-gradient saliency maps.

Counterpart of ``multimodal_deepfake_detection_tpu/utils/saliency.py``: the
per-pixel attribution of a fake score is the gradient of that score with
respect to the input frames, here one ``torch.autograd.grad`` through the
eval forward (BN on its running statistics, no dropout). Only the input's
gradient is asked for, so no parameter gradient is computed or kept; the
backward keeps every activation of the forward on the device, which sets
the peak memory of a saliency batch. The PNG export is numpy and
matplotlib (Agg) on the host.
"""
from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch


def input_saliency(score_fn: Callable, frames: torch.Tensor, *args) -> torch.Tensor:
    """Per-pixel saliency of ``score_fn`` w.r.t. ``frames``.

    ``score_fn(frames, *args) -> (B,) scores`` (e.g. fake probabilities or
    logits). Returns ``|d sum(score) / d frames|`` in fp32, max-reduced over
    the channel axis: shape ``frames.shape[:-1]``. Gradients of independent
    samples don't mix, so summing the scores gives every sample its own
    attribution in one backward pass.
    """
    x = frames.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        (grads,) = torch.autograd.grad(score_fn(x, *args).sum(), x)
    return grads.float().abs().amax(dim=-1)


def normalize_map(sal: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    """Min-max normalize each (..., H, W) map independently to [0, 1]."""
    sal = np.asarray(sal, np.float32)
    lo = sal.min(axis=(-2, -1), keepdims=True)
    hi = sal.max(axis=(-2, -1), keepdims=True)
    return (sal - lo) / np.maximum(hi - lo, eps)


def save_saliency_grid(
    frames: np.ndarray,
    sal: np.ndarray,
    path: str,
    *,
    scores: Optional[np.ndarray] = None,
    labels: Optional[np.ndarray] = None,
    max_samples: int = 4,
    max_frames: int = 6,
    log=print,
) -> str:
    """Overlay saliency heatmaps on frames and save a PNG grid.

    ``frames`` (B, T, H, W, 3) in [0, 1]; ``sal`` (B, T, H, W). One row per
    sample, one column per frame, jet overlay at 45% alpha.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    frames = np.asarray(frames, np.float32)
    sal = normalize_map(sal)
    B = min(frames.shape[0], max_samples)
    T = min(frames.shape[1], max_frames)
    fig, axes = plt.subplots(B, T, figsize=(2.2 * T, 2.4 * B), squeeze=False)
    for i in range(B):
        for t in range(T):
            ax = axes[i][t]
            ax.imshow(np.clip(frames[i, t], 0, 1))
            ax.imshow(sal[i, t], cmap="jet", alpha=0.45)
            ax.set_xticks([])
            ax.set_yticks([])
            if t == 0:
                title = f"sample {i}"
                if labels is not None:
                    title += f" y={int(labels[i])}"
                if scores is not None:
                    title += f" p={float(scores[i]):.2f}"
                ax.set_ylabel(title, fontsize=8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig.tight_layout()
    fig.savefig(path, dpi=160)
    plt.close(fig)
    log(f"[Saliency] saved -> {path}")
    return path
