"""Xception backbone with live batch norm, eval mode.

Counterpart of ``multimodal_deepfake_detection_tpu/models/xception.py``: the
same block table, the same parameter shapes (in PyTorch layouts) and the same
eval forward on NHWC images. Serving runs the BN-folded form
(``models/fold.py``); this module is what gets folded, and what the fold is
checked against.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.conv import (
    BatchNorm,
    Linear,
    SeparableConv,
    conv2d,
    global_avg_pool,
    he_normal,
    max_pool2d,
)

# (in_ch, out_ch, reps, stride, start_with_relu, grow_first)
# Entry: blocks 0-2; middle: 3-10; exit: 11.
XCEPTION_BLOCK_SPECS = (
    (64, 128, 2, 2, False, True),
    (128, 256, 2, 2, True, True),
    (256, 728, 2, 2, True, True),
) + ((728, 728, 3, 1, True, True),) * 8 + (
    (728, 1024, 2, 2, True, False),
)


def block_unit_channels(spec):
    """Per-rep (in, out) channel pairs for one block's separable convs."""
    in_ch, out_ch, reps, _, _, grow_first = spec
    if grow_first:
        return [(in_ch, out_ch)] + [(out_ch, out_ch)] * (reps - 1)
    return [(in_ch, in_ch)] * (reps - 1) + [(in_ch, out_ch)]


class XceptionUnit(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, generator=None):
        super().__init__()
        self.sep = SeparableConv(in_ch, out_ch, generator)
        self.bn = BatchNorm(out_ch)


class Skip(nn.Module):
    """1x1 projection conv + BN on a block's shortcut."""

    def __init__(self, in_ch: int, out_ch: int, generator=None):
        super().__init__()
        self.conv = nn.Parameter(he_normal((out_ch, in_ch, 1, 1), generator))
        self.bn = BatchNorm(out_ch)


class XceptionBlock(nn.Module):
    """``reps`` units of [ReLU -> sepconv3x3 -> BN], a 3x3/s2 max pool when
    strided, and a projection shortcut whenever channels or stride change."""

    def __init__(self, spec, generator=None):
        super().__init__()
        in_ch, out_ch, _, stride, start_with_relu, _ = spec
        self.stride = stride
        self.start_with_relu = start_with_relu
        self.units = nn.ModuleList(
            XceptionUnit(ci, co, generator) for ci, co in block_unit_channels(spec)
        )
        self.skip = Skip(in_ch, out_ch, generator) if (out_ch != in_ch or stride != 1) else None

    def forward(self, x, compute_dtype=None):
        h = x
        for i, unit in enumerate(self.units):
            if i > 0 or self.start_with_relu:
                h = torch.relu(h)
            h = unit.bn(unit.sep(h, compute_dtype))
        if self.stride != 1:
            h = max_pool2d(h, 3, self.stride, 1)
        if self.skip is not None:
            skip = conv2d(x, self.skip.conv, stride=self.stride, compute_dtype=compute_dtype)
            skip = self.skip.bn(skip)
        else:
            skip = x
        return h + skip


class Xception(nn.Module):
    """Entry flow, 8 middle blocks, exit flow, global pool, optional fc.

    ``num_classes=None`` omits the fc head (the per-frame feature extractor
    of the temporal heads). Weights come from ``generator``.
    """

    def __init__(self, num_classes: Optional[int] = 1000, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.conv1 = nn.Parameter(he_normal((32, 3, 3, 3), g))
        self.bn1 = BatchNorm(32)
        self.conv2 = nn.Parameter(he_normal((64, 32, 3, 3), g))
        self.bn2 = BatchNorm(64)
        self.blocks = nn.ModuleList(XceptionBlock(spec, g) for spec in XCEPTION_BLOCK_SPECS)
        self.conv3 = SeparableConv(1024, 1536, g)
        self.bn3 = BatchNorm(1536)
        self.conv4 = SeparableConv(1536, 2048, g)
        self.bn4 = BatchNorm(2048)
        self.fc = Linear(2048, num_classes, g) if num_classes is not None else None

    def forward(self, x: torch.Tensor, *, compute_dtype=None, features_only: bool = False,
                upto: Optional[str] = None) -> torch.Tensor:
        """Eval forward on NHWC images with running BN statistics.

        ``upto`` ("stem", "block<k>", "exit") returns that stage's output.
        """
        h = torch.relu(self.bn1(conv2d(x, self.conv1, stride=2, compute_dtype=compute_dtype)))
        h = torch.relu(self.bn2(conv2d(h, self.conv2, compute_dtype=compute_dtype)))
        if upto == "stem":
            return h
        for k, block in enumerate(self.blocks):
            h = block(h, compute_dtype)
            if upto == f"block{k + 1}":
                return h
        h = torch.relu(self.bn3(self.conv3(h, compute_dtype)))
        h = torch.relu(self.bn4(self.conv4(h, compute_dtype)))
        if upto == "exit":
            return h
        feats = global_avg_pool(h)
        if features_only or self.fc is None:
            return feats
        return self.fc(feats, compute_dtype)
