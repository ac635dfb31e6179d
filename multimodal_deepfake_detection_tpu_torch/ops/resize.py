"""Bilinear resize with ``align_corners=False`` semantics.

Counterpart of ``multimodal_deepfake_detection_tpu/ops/resize.py``, which
calls ``jax.image.resize(method="bilinear", antialias=False)``: the same
half-pixel-centre linear kernel, without antialiasing on downscale.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .conv import to_nchw, to_nhwc


def resize_bilinear(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Resize the spatial dims of ``(..., H, W, C)``."""
    lead, (h, w, c) = x.shape[:-3], x.shape[-3:]
    flat = x.reshape((-1, h, w, c))
    out = F.interpolate(
        to_nchw(flat), size=tuple(out_hw), mode="bilinear", align_corners=False, antialias=False
    )
    return to_nhwc(out).reshape(lead + tuple(out_hw) + (c,))
