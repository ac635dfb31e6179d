"""ResNet-18 feature extractor with live batch norm.

Counterpart of ``multimodal_deepfake_detection_tpu/models/resnet.py``: the
per-image backbone of both AU models. A 7x7 stride-2 stem with pad 3, a 3x3
stride-2 max pool, four stages of two BasicBlocks (64, 128, 256, 512
channels; a 1x1 projection on the shortcut where the stride or the width
changes) and a global average pool in fp32, on NHWC images. BN runs from
its running statistics, unfolded, as the JAX scorers serve it
(``resnet18_apply(train=False)``; ``models/fold.py`` folds it for the
quantizer), or from batch statistics in training
(:meth:`ResNet18.train_forward`, ``train=True``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.conv import BatchNorm, conv2d, global_avg_pool, he_normal, max_pool2d
from .xception import BNStats, Skip, bn_forward

# (out_channels, stride) of each stage's first block; 2 blocks per stage
RESNET18_STAGES = ((64, 1), (128, 2), (256, 2), (512, 2))
FEATURE_DIM = 512


class BasicBlock(nn.Module):
    """Two 3x3 convs with BN; ``downsample`` (1x1 conv + BN) or None."""

    def __init__(self, in_ch: int, out_ch: int, stride: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stride = stride
        self.conv1 = nn.Parameter(he_normal((out_ch, in_ch, 3, 3), generator))
        self.bn1 = BatchNorm(out_ch)
        self.conv2 = nn.Parameter(he_normal((out_ch, out_ch, 3, 3), generator))
        self.bn2 = BatchNorm(out_ch)
        self.downsample = (Skip(in_ch, out_ch, generator)
                           if stride != 1 or in_ch != out_ch else None)

    def forward(self, x: torch.Tensor, compute_dtype: Optional[torch.dtype] = None,
                stats: Optional[BNStats] = None) -> torch.Tensor:
        """Running statistics; batch statistics when ``stats`` is a list, to
        which each BN is appended with its batch statistics."""
        h = conv2d(x, self.conv1, stride=self.stride, padding=1, compute_dtype=compute_dtype)
        h = torch.relu(bn_forward(self.bn1, h, stats))
        h = conv2d(h, self.conv2, padding=1, compute_dtype=compute_dtype)
        h = bn_forward(self.bn2, h, stats)
        idn = x
        if self.downsample is not None:
            idn = conv2d(x, self.downsample.conv, stride=self.stride, compute_dtype=compute_dtype)
            idn = bn_forward(self.downsample.bn, idn, stats)
        return torch.relu(h + idn)


class ResNet18(nn.Module):
    """``(N, H, W, 3)`` -> ``(N, 512)`` pooled features in the compute dtype."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = nn.Parameter(he_normal((64, 3, 7, 7), generator))
        self.bn1 = BatchNorm(64)
        stages, in_ch = [], 64
        for out_ch, stride in RESNET18_STAGES:
            stages.append(nn.ModuleList([BasicBlock(in_ch, out_ch, stride, generator),
                                         BasicBlock(out_ch, out_ch, 1, generator)]))
            in_ch = out_ch
        self.stages = nn.ModuleList(stages)

    def forward(self, x: torch.Tensor, compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        return self._run(x, compute_dtype, None)

    def train_forward(self, x: torch.Tensor, compute_dtype: Optional[torch.dtype] = None
                      ) -> Tuple[torch.Tensor, BNStats]:
        """Batch-statistics forward (``resnet18_apply(train=True)``):
        ``(features, stats)``, every BN (the stem's, each block's ``bn1``,
        ``bn2`` and shortcut BN) with its batch statistics over all ``N``
        images; the running statistics change only when the caller passes
        ``stats`` to :func:`~.xception.apply_bn_stats`, once a step."""
        stats: BNStats = []
        return self._run(x, compute_dtype, stats), stats

    def _run(self, x, compute_dtype, stats):
        h = conv2d(x, self.conv1, stride=2, padding=3, compute_dtype=compute_dtype)
        h = max_pool2d(torch.relu(bn_forward(self.bn1, h, stats)), 3, 2, 1)
        for stage in self.stages:
            for block in stage:
                h = block(h, compute_dtype, stats)
        return global_avg_pool(h)
