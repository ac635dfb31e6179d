"""Inference-time batch-norm folding for Xception, and the folded forward.

Counterpart of ``multimodal_deepfake_detection_tpu/models/fold.py``. In eval
mode every BN is an affine map with fixed statistics, so it folds exactly
into the preceding convolution:

    w' = w * scale/sqrt(var+eps)        (per output channel)
    b' = bias - mean * scale/sqrt(var+eps)

The folded module stores its conv weights in one compute dtype (the JAX
package casts them per call to the same values). Packed from the fp32 fold,
each block also keeps the operands of the kernels that can run it, and
``FoldedXception.forward(use_kernels=True, ...)`` routes:

- the 8 middle-flow blocks (stride 1, no skip, square, leading ReLU) through
  K1 (``ops/kernels/middle_block.py``) at any trunk size, with
  ``middle_taps="bf16"`` in ``middle_block_pallas_v2(precise=False)``'s tap
  order;
- with ``fuse_entry``, the stride-2 two-unit blocks with a skip (entry
  blocks 1-3 and block 12) through K3 (``ops/kernels/entry_block.py``), the
  JAX ``use_pallas=True`` route with ``MDFD_ENTRY_FUSE_H`` listing every
  stride-2 block's input height;
- with ``entry_pair``, the separable pair of those blocks through K4
  (``ops/kernels/entry_pair.py``, ``entry_pair_pallas``'s switches), the max
  pool and the skip left to cuDNN: the split the JAX ``tools/microbench.py``
  times;
- with ``fuse_exit``, the exit sepconvs conv3 and conv4 through K5
  (``ops/kernels/sepconv_unit.py``) with their trailing ReLU fused, the
  targets ``sepconv_unit_pallas`` names.

:func:`fold_resnet18_bn` folds the AU models' ResNet-18 the same way into a
:class:`FoldedResNet18`, held in fp32: the quantizer
(``models/quant.py``) reads it, and no kernel runs it.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.conv import conv2d, global_avg_pool, linear, max_pool2d
from ..ops.kernels.entry_block import entry_block, pack_entry_block
from ..ops.kernels.entry_pair import entry_pair as _entry_pair
from ..ops.kernels.middle_block import TAPS, middle_block, pack_middle_block
from ..ops.kernels.sepconv_unit import pack_unit, sepconv_unit
from .resnet import ResNet18
from .xception import Xception

_EPS = 1e-5
K3_OPERANDS = ("dw0", "pw0", "b0", "dw1", "pw1", "b1", "skw", "skb")


def _fold(w: torch.Tensor, bn) -> tuple:
    """OIHW weight + BN -> fp32 (w', b')."""
    scale_eff = bn.scale.float() * torch.rsqrt(bn.var.float() + _EPS)
    return w.float() * scale_eff.view(-1, 1, 1, 1), bn.bias.float() - bn.mean.float() * scale_eff


def _fold_sep(sep, bn) -> tuple:
    """SeparableConv + BN -> fp32 (dw, pw', b')."""
    return (sep.depthwise.detach().float(), *_fold(sep.pointwise.detach(), bn))


class FoldedSep(nn.Module):
    """Depthwise 3x3 + pointwise 1x1 with the folded BN bias; with
    ``pack_k5``, also K5's operands packed from the fp32 fold."""

    def __init__(self, dw: torch.Tensor, pw: torch.Tensor, b: torch.Tensor, dtype: torch.dtype,
                 pack_k5: bool = False):
        super().__init__()
        self.register_buffer("dw", dw.to(dtype))
        self.register_buffer("pw", pw.to(dtype))
        self.register_buffer("b", b.to(dtype))
        if pack_k5:
            for name, t in zip(("k5_dw", "k5_pw", "k5_b"), pack_unit(dw, pw, b)):
                self.register_buffer(name, t)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = conv2d(x, self.dw, padding=1, groups=x.shape[-1])
        return conv2d(h, self.pw, self.b)

    def forward_relu(self, x: torch.Tensor, use_kernels: bool = False) -> torch.Tensor:
        """ReLU(unit(x)); through K5 with its trailing ReLU fused when
        ``use_kernels``."""
        if use_kernels:
            return sepconv_unit(x.contiguous(), self.k5_dw, self.k5_pw, self.k5_b,
                                leading_relu=False, trailing_relu=True)
        return torch.relu(self(x))


class FoldedBlock(nn.Module):
    def __init__(self, block, dtype: torch.dtype):
        super().__init__()
        self.stride = block.stride
        self.start_with_relu = block.start_with_relu
        folded = [_fold_sep(u.sep, u.bn) for u in block.units]
        self.units = nn.ModuleList(FoldedSep(*f, dtype) for f in folded)
        if block.skip is not None:
            skip = _fold(block.skip.conv.detach(), block.skip.bn)
            self.register_buffer("skip_w", skip[0].to(dtype))
            self.register_buffer("skip_b", skip[1].to(dtype))
        else:
            self.skip_w = self.skip_b = None
        self.is_middle = is_middle_block(self)
        if self.is_middle:
            dw, pw, b = pack_middle_block(folded)
            self.register_buffer("k1_dw", dw)
            self.register_buffer("k1_pw", pw)
            self.register_buffer("k1_b", b)
        self.is_entry = is_entry_block(self)
        if self.is_entry:  # packed from the fp32 fold, as K1's weights are
            for name, t in zip(K3_OPERANDS, pack_entry_block(folded, skip)):
                self.register_buffer(f"k3_{name}", t)

    def k3_operands(self) -> tuple:
        """K3's packed operands, in :func:`entry_block`'s order; the first six
        are K4's, in :func:`entry_pair`'s."""
        return tuple(getattr(self, f"k3_{name}") for name in K3_OPERANDS)

    def forward(self, x: torch.Tensor, use_kernels: bool = False, fuse_entry: bool = False, *,
                entry_pair: bool = False, middle_taps: str = "fp32") -> torch.Tensor:
        if use_kernels and self.is_middle:
            return middle_block(x.contiguous(), self.k1_dw, self.k1_pw, self.k1_b,
                                taps=middle_taps)
        if use_kernels and fuse_entry and self.is_entry:
            return entry_block(x.contiguous(), *self.k3_operands(),
                               leading_relu0=self.start_with_relu)
        if use_kernels and entry_pair and self.is_entry:
            h = _entry_pair(x.contiguous(), *self.k3_operands()[:6],
                            leading_relu0=self.start_with_relu)
        else:
            h = x
            for i, unit in enumerate(self.units):
                if i > 0 or self.start_with_relu:
                    h = torch.relu(h)
                h = unit(h)
        if self.stride != 1:
            h = max_pool2d(h, 3, self.stride, 1)
        if self.skip_w is not None:
            return h + conv2d(x, self.skip_w, self.skip_b, stride=self.stride)
        return h + x


def is_middle_block(block: FoldedBlock) -> bool:
    """True for the blocks K1 computes: stride 1, leading ReLU, no projection,
    every pointwise C -> C."""
    if block.stride != 1 or not block.start_with_relu or block.skip_w is not None:
        return False
    c = block.units[0].pw.shape[0]
    return all(tuple(u.pw.shape[:2]) == (c, c) for u in block.units)


def is_entry_block(block: FoldedBlock) -> bool:
    """True for the blocks K3 computes: stride 2, a projection skip, two
    units (the JAX ``is_fusable_entry_block`` without its env gate)."""
    return block.stride == 2 and block.skip_w is not None and len(block.units) == 2


class FoldedXception(nn.Module):
    """BN-free Xception; ``forward`` mirrors :class:`Xception`'s eval forward."""

    def __init__(self, model: Xception, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        for name, bn in (("conv1", model.bn1), ("conv2", model.bn2)):
            w, b = _fold(getattr(model, name).detach(), bn)
            self.register_buffer(f"{name}_w", w.to(dtype))
            self.register_buffer(f"{name}_b", b.to(dtype))
        self.blocks = nn.ModuleList(FoldedBlock(blk, dtype) for blk in model.blocks)
        self.conv3 = FoldedSep(*_fold_sep(model.conv3, model.bn3), dtype, pack_k5=True)
        self.conv4 = FoldedSep(*_fold_sep(model.conv4, model.bn4), dtype, pack_k5=True)
        if model.fc is not None:
            self.register_buffer("fc_w", model.fc.w.detach().to(dtype))
            self.register_buffer("fc_b", model.fc.b.detach().to(dtype))
        else:
            self.fc_w = self.fc_b = None

    def forward(self, x: torch.Tensor, *, features_only: bool = False, use_kernels: bool = False,
                fuse_entry: bool = False, entry_pair: bool = False, middle_taps: str = "fp32",
                fuse_exit: bool = False, upto: Optional[str] = None) -> torch.Tensor:
        """NHWC images -> features (or logits). ``use_kernels`` routes the
        middle blocks through K1 (``middle_taps`` its tap order); with
        ``fuse_entry`` the stride-2 blocks through K3, or with ``entry_pair``
        their separable pairs through K4; with ``fuse_exit`` conv3 and conv4
        through K5. ``upto`` ("stem", "block<k>", "exit") returns that
        stage's output."""
        check_routes(fuse_entry=fuse_entry, entry_pair=entry_pair, middle_taps=middle_taps)
        x = x.to(self.dtype)
        h = torch.relu(conv2d(x, self.conv1_w, self.conv1_b, stride=2))
        h = torch.relu(conv2d(h, self.conv2_w, self.conv2_b))
        if upto == "stem":
            return h
        for k, block in enumerate(self.blocks):
            h = block(h, use_kernels, fuse_entry, entry_pair=entry_pair, middle_taps=middle_taps)
            if upto == f"block{k + 1}":
                return h
        h = self.conv3.forward_relu(h, use_kernels and fuse_exit)
        h = self.conv4.forward_relu(h, use_kernels and fuse_exit)
        if upto == "exit":
            return h
        feats = global_avg_pool(h)
        if features_only or self.fc_w is None:
            return feats
        return linear(feats, self.fc_w, self.fc_b)


def check_routes(*, fuse_entry: bool = False, entry_pair: bool = False,
                 middle_taps: str = "fp32") -> None:
    """Raises on a combination of kernel routes that does not exist: K3 and K4
    both claim the stride-2 blocks, and K1 has two tap orders."""
    if fuse_entry and entry_pair:
        raise ValueError("fuse_entry (K3, the whole stride-2 block) and entry_pair (K4, its "
                         "separable pair) route the same blocks: choose one")
    if middle_taps not in TAPS:
        raise ValueError(f"middle_taps must be 'fp32' or 'bf16', got {middle_taps!r}")


def fold_xception_bn(model: Xception, dtype: torch.dtype = torch.float32) -> FoldedXception:
    """Fold a live-BN :class:`Xception` into a BN-free module in ``dtype``."""
    with torch.no_grad():
        return FoldedXception(model, dtype)


class FoldedBasicBlock(nn.Module):
    """A folded BasicBlock: ``conv1``, ``conv2`` and ``downsample`` as fp32
    ``<name>_w`` / ``<name>_b`` buffers (``downsample_*`` None without a
    projection)."""

    def __init__(self, block):
        super().__init__()
        self.stride = block.stride
        down = block.downsample
        for name, conv, bn in (("conv1", block.conv1, block.bn1), ("conv2", block.conv2, block.bn2),
                               ("downsample", down and down.conv, down and down.bn)):
            w, b = _fold(conv.detach(), bn) if conv is not None else (None, None)
            self.register_buffer(f"{name}_w", w)
            self.register_buffer(f"{name}_b", b)

    def forward(self, x: torch.Tensor, compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        cd = compute_dtype
        r = torch.relu(conv2d(x, self.conv1_w, self.conv1_b, stride=self.stride, padding=1,
                              compute_dtype=cd))
        r = conv2d(r, self.conv2_w, self.conv2_b, padding=1, compute_dtype=cd)
        idn = x
        if self.downsample_w is not None:
            idn = conv2d(x, self.downsample_w, self.downsample_b, stride=self.stride,
                         compute_dtype=cd)
        return torch.relu(r + idn)


class FoldedResNet18(nn.Module):
    """BN-free ResNet-18 in fp32; ``forward`` mirrors :class:`ResNet18`'s."""

    def __init__(self, model: ResNet18):
        super().__init__()
        w, b = _fold(model.conv1.detach(), model.bn1)
        self.register_buffer("conv1_w", w)
        self.register_buffer("conv1_b", b)
        self.stages = nn.ModuleList(
            nn.ModuleList(FoldedBasicBlock(blk) for blk in stage) for stage in model.stages)

    def forward(self, x: torch.Tensor, compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        h = conv2d(x, self.conv1_w, self.conv1_b, stride=2, padding=3, compute_dtype=compute_dtype)
        h = max_pool2d(torch.relu(h), 3, 2, 1)
        for stage in self.stages:
            for block in stage:
                h = block(h, compute_dtype)
        return global_avg_pool(h)


def fold_resnet18_bn(model: ResNet18) -> FoldedResNet18:
    """Fold a live-BN :class:`ResNet18` into a BN-free fp32 module."""
    with torch.no_grad():
        return FoldedResNet18(model)
