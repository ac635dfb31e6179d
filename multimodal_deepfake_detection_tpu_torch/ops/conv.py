"""NHWC convolution, pooling, batch-norm and linear layers over PyTorch.

Counterpart of ``multimodal_deepfake_detection_tpu/ops/conv.py``: eval-mode
batch norm, and the train mode that JAX runs by default (single-pass fp32
batch statistics, :func:`batch_norm_train`).
Public functions keep the JAX layout: NHWC activations. Weights are held in
PyTorch's layout (conv OIHW, depthwise ``(C, 1, kh, kw)``, linear
``(out, in)``); ``utils/jax_weights.py`` converts. Inside, ``x.permute(0, 3,
1, 2)`` of a contiguous NHWC tensor is an NCHW tensor in
``torch.channels_last`` memory format — no copy — so ``F.conv2d`` runs on the
same NHWC bytes and returns channels_last, which permutes back to NHWC for free.

Init follows the JAX package (He-normal with fan = kh*kw*out for convs,
U(+-1/sqrt(in)) for linear) from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core.precision import at_least_f32
from ..parallel.distributed import all_reduce_sum, data_group


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> NCHW view (channels_last memory format when x is contiguous)."""
    return x.permute(0, 3, 1, 2)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> NHWC view."""
    return x.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# Functions on tensors
# ---------------------------------------------------------------------------

def conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    *,
    stride=1,
    padding=0,
    groups: int = 1,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """2-D convolution, NHWC x OIHW (+ bias) -> NHWC."""
    if compute_dtype is not None:
        x, w = x.to(compute_dtype), w.to(compute_dtype)
        b = None if b is None else b.to(compute_dtype)
    return to_nhwc(F.conv2d(to_nchw(x), w, b, stride=stride, padding=padding, groups=groups))


def max_pool2d(x: torch.Tensor, kernel_size=3, stride=2, padding=1) -> torch.Tensor:
    """NHWC max pool with implicit -inf padding (torch semantics)."""
    return to_nhwc(F.max_pool2d(to_nchw(x), kernel_size, stride, padding))


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, C): mean taken in fp32, cast back to x.dtype."""
    return at_least_f32(x).mean(dim=(1, 2)).to(x.dtype)


def batch_norm_eval(x, scale, bias, mean, var, eps: float = 1e-5) -> torch.Tensor:
    """Channel-last eval-mode BN with running statistics, math in fp32."""
    s = at_least_f32(scale) * torch.rsqrt(var + eps)
    shift = at_least_f32(bias) - mean * s
    return (at_least_f32(x) * s + shift).to(x.dtype)


def batch_norm_train(x, scale, bias, eps: float = 1e-5):
    """Channel-last train-mode BN with batch statistics over all leading axes:
    ``(out, mean, unbiased_var)``.

    The JAX default (``_bn_train_core``): fp32 statistics with the single-pass
    variance ``max(E[x^2] - E[x]^2, 0)`` (each mean a sum over the count, as
    ``jnp.mean``), normalisation by that biased variance, the output cast
    back to ``x.dtype``. Gradients come from autograd through this formula.
    ``mean`` and the unbiased variance (``var * n / (n - 1)``) come back
    detached, for the running statistics: they are no-grad buffer writes,
    applied by :meth:`BatchNorm.update`. ``F.batch_norm(training=True)`` is
    not used: its variance is two-pass and it normalises bf16 inputs
    differently.

    Inside ``parallel.distributed.data_parallel(group)`` the statistics are
    the global batch's: the sums ``(sum x, sum x^2, count)`` are all-reduced
    over the group in one differentiable SUM, as XLA reduces them over the
    data axis in JAX; one rank's all-reduce is a copy, so a group of one
    computes what no group does, bit for bit."""
    xf = at_least_f32(x)
    dims = tuple(range(x.ndim - 1))
    count = torch.full_like(xf[(0,) * (x.ndim - 1)], x.numel() // x.shape[-1])
    sums = torch.stack([xf.sum(dim=dims), (xf * xf).sum(dim=dims), count])
    group = data_group()
    if group is not None:
        sums = all_reduce_sum(sums, group)
    n = sums[2].detach()
    mean = sums[0] / n
    var = (sums[1] / n - mean * mean).clamp_min(0.0)
    rstd = torch.rsqrt(var + eps)
    out = (xf - mean) * (rstd * at_least_f32(scale)) + at_least_f32(bias)
    return out.to(x.dtype), mean.detach(), var.detach() * (n / (n - 1).clamp_min(1))


def linear(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    *,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """``x @ w.T + b`` with ``w`` as ``(out, in)``."""
    if compute_dtype is not None:
        x, w = x.to(compute_dtype), w.to(compute_dtype)
        b = None if b is None else b.to(compute_dtype)
    return F.linear(x, w, b)


def dense(layer: "Linear", x: torch.Tensor, compute_dtype: Optional[torch.dtype] = None
          ) -> torch.Tensor:
    """``x @ w.T`` then ``+ b`` in the compute dtype: two roundings, as the
    JAX ``linear`` (a dot, then the bias add); :func:`linear` is one fused
    ``addmm``."""
    dtype = compute_dtype or torch.promote_types(x.dtype, layer.w.dtype)
    return x.to(dtype) @ layer.w.to(dtype).T + layer.b.to(dtype)


# ---------------------------------------------------------------------------
# Parameter holders
# ---------------------------------------------------------------------------

def he_normal(shape, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """normal(0, sqrt(2/n)), n = kh*kw*out_channels (OIHW ``shape``)."""
    out_ch, _, kh, kw = shape
    return torch.randn(shape, generator=generator) * math.sqrt(2.0 / (kh * kw * out_ch))


class BatchNorm(nn.Module):
    """Affine params + running statistics of one BN layer."""

    def __init__(self, num_features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("mean", torch.zeros(num_features))
        self.register_buffer("var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return batch_norm_eval(x, self.scale, self.bias, self.mean, self.var)

    def train_forward(self, x: torch.Tensor):
        """Batch statistics: ``(out, (mean, unbiased_var))``; the running
        statistics stay as they are until :meth:`update`."""
        out, mean, var = batch_norm_train(x, self.scale, self.bias)
        return out, (mean, var)

    @torch.no_grad()
    def update(self, mean: torch.Tensor, var: torch.Tensor, momentum: float = 0.1) -> None:
        """``running = (1 - momentum) * running + momentum * batch``, as JAX
        computes it."""
        self.mean.copy_((1 - momentum) * self.mean + momentum * mean)
        self.var.copy_((1 - momentum) * self.var + momentum * var)


class SeparableConv(nn.Module):
    """Depthwise 3x3 (groups=in) + pointwise 1x1, both bias-free."""

    def __init__(self, in_ch: int, out_ch: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.depthwise = nn.Parameter(he_normal((in_ch, 1, 3, 3), generator))
        self.pointwise = nn.Parameter(he_normal((out_ch, in_ch, 1, 1), generator))

    def forward(self, x: torch.Tensor, compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        h = conv2d(x, self.depthwise, padding=1, groups=x.shape[-1], compute_dtype=compute_dtype)
        return conv2d(h, self.pointwise, compute_dtype=compute_dtype)


class Linear(nn.Module):
    """``(out, in)`` weight + bias, torch.nn.Linear's default init."""

    def __init__(self, in_features: int, out_features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        bound = 1.0 / math.sqrt(in_features)
        u = lambda *shape: (torch.rand(shape, generator=generator) * 2 - 1) * bound
        self.w = nn.Parameter(u(out_features, in_features))
        self.b = nn.Parameter(u(out_features))

    def forward(self, x: torch.Tensor, compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        return linear(x, self.w, self.b, compute_dtype=compute_dtype)
