"""Xception backbone with live batch norm.

Counterpart of ``multimodal_deepfake_detection_tpu/models/xception.py``: the
same block table, the same parameter shapes (in PyTorch layouts) and the same
forward on NHWC images, with running statistics (:meth:`Xception.forward`)
or batch statistics (:meth:`Xception.train_forward`, what training runs).
Serving runs the BN-folded form (``models/fold.py``); this module is what
gets folded, and what the fold is checked against.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

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


# each BN of a batch-statistics forward with its (mean, unbiased var)
BNStats = List[Tuple[BatchNorm, Tuple[torch.Tensor, torch.Tensor]]]


def apply_bn_stats(stats: BNStats, momentum: float = 0.1) -> None:
    """Fold a :meth:`Xception.train_forward`'s batch statistics into the
    running statistics, once per step (the JAX ``new_state``)."""
    for bn, (mean, var) in stats:
        bn.update(mean, var, momentum)


def bn_forward(bn: BatchNorm, h: torch.Tensor, stats: Optional[BNStats]) -> torch.Tensor:
    """Running statistics when ``stats`` is None; else batch statistics,
    appended to ``stats`` with their BN."""
    if stats is None:
        return bn(h)
    out, st = bn.train_forward(h)
    stats.append((bn, st))
    return out


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

    def forward(self, x, compute_dtype=None, train: bool = False):
        """Running statistics; ``train`` returns ``(out, stats)``, each BN
        with its batch statistics, and writes no buffer, so a checkpointed
        block recomputes without side effects."""
        stats = [] if train else None
        h = x
        for i, unit in enumerate(self.units):
            if i > 0 or self.start_with_relu:
                h = torch.relu(h)
            h = bn_forward(unit.bn, unit.sep(h, compute_dtype), stats)
        if self.stride != 1:
            h = max_pool2d(h, 3, self.stride, 1)
        if self.skip is not None:
            skip = conv2d(x, self.skip.conv, stride=self.stride, compute_dtype=compute_dtype)
            skip = bn_forward(self.skip.bn, skip, stats)
        else:
            skip = x
        return (h + skip, stats) if train else h + skip


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
        return self._run(x, compute_dtype, features_only, upto, None, False)

    def train_forward(self, x: torch.Tensor, *, compute_dtype=None, remat: bool = False
                      ) -> Tuple[torch.Tensor, BNStats]:
        """Batch-statistics forward (``xception_apply(train=True)``):
        ``(outputs, stats)``, every BN paired with its batch statistics; the
        running statistics change only when the caller passes ``stats`` to
        :func:`apply_bn_stats`. ``remat`` runs each block under
        ``torch.utils.checkpoint`` (``jax.checkpoint`` in JAX): the backward
        recomputes the block's activations, gradients unchanged."""
        stats: BNStats = []
        return self._run(x, compute_dtype, False, None, stats, remat), stats

    def _run(self, x, compute_dtype, features_only, upto, stats, remat):
        bn = lambda m, h: bn_forward(m, h, stats)
        h = torch.relu(bn(self.bn1, conv2d(x, self.conv1, stride=2, compute_dtype=compute_dtype)))
        h = torch.relu(bn(self.bn2, conv2d(h, self.conv2, compute_dtype=compute_dtype)))
        if upto == "stem":
            return h
        for k, block in enumerate(self.blocks):
            if stats is None:
                h = block(h, compute_dtype)
            else:
                h, st = (checkpoint(block, h, compute_dtype, True, use_reentrant=False,
                                    preserve_rng_state=False)
                         if remat else block(h, compute_dtype, True))
                stats.extend(st)
            if upto == f"block{k + 1}":
                return h
        h = torch.relu(bn(self.bn3, self.conv3(h, compute_dtype)))
        h = torch.relu(bn(self.bn4, self.conv4(h, compute_dtype)))
        if upto == "exit":
            return h
        feats = global_avg_pool(h)
        if features_only or self.fc is None:
            return feats
        return self.fc(feats, compute_dtype)
