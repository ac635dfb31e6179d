"""Loss zoo: every objective the JAX package trains with, as functions.

Counterpart of ``multimodal_deepfake_detection_tpu/models/losses.py``: BCE on
probabilities (with torch ``nn.BCELoss``'s clamped backward), BCE with
logits, label smoothing, binary focal, cross-entropy with class and sample
weights, the class-balanced focal loss and its weights, the logit clamp, the
cross-modal alignment MSE, temporal smoothness and the adaptive mixer.

All reductions are means (or weighted means when ``sample_weight`` masks
batch-padding rows); everything is at least fp32 inside. Inside
``parallel.distributed.data_parallel(group)`` the BCE, focal and
cross-entropy means are the global batch's: each rank returns its rows'
weighted sum over the global weight (a SUM all-reduce), its share of the
global loss, so the shares' gradients add up to the global loss's.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ..core.precision import at_least_f32
from ..parallel.distributed import data_group, global_sum


def _wmean(values: torch.Tensor, sample_weight: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean, or weighted mean when ``sample_weight`` is given (this rank's
    share of the global one under ``data_parallel``)."""
    if data_group() is not None:
        w = (torch.ones_like(values) if sample_weight is None
             else at_least_f32(sample_weight).reshape(values.shape))
        return (w * values).sum() / global_sum(w.sum()).clamp_min(1e-12)
    if sample_weight is None:
        return values.mean()
    w = at_least_f32(sample_weight).reshape(values.shape)
    return (w * values).sum() / w.sum().clamp_min(1e-12)


class _BCEElem(torch.autograd.Function):
    """Elementwise BCE on probabilities: log terms clamped at -100 forward;
    backward ``(p - t) / max(p(1 - p), 1e-12)`` for ``p`` (torch's, finite at
    p in {0, 1}) and, deliberately, the clamped log terms for ``t``, so
    d/dt stays within +-200 where torch's is infinite (the JAX
    ``_bce_elem``)."""

    @staticmethod
    def forward(ctx, p, t):
        ctx.save_for_backward(p, t)
        log_p = torch.log(p).clamp_min(-100.0)
        log_1mp = torch.log(1.0 - p).clamp_min(-100.0)
        return -(t * log_p + (1 - t) * log_1mp)

    @staticmethod
    def backward(ctx, g):
        p, t = ctx.saved_tensors
        dp = (p - t) / (p * (1.0 - p)).clamp_min(1e-12)
        dt = torch.log(1.0 - p).clamp_min(-100.0) - torch.log(p).clamp_min(-100.0)
        return g * dp, g * dt


def bce_loss(probs: torch.Tensor, targets: torch.Tensor, *, sample_weight=None) -> torch.Tensor:
    """Binary cross-entropy on probabilities (torch ``nn.BCELoss``)."""
    return _wmean(_BCEElem.apply(at_least_f32(probs), at_least_f32(targets)), sample_weight)


def _bce_logits_elem(z: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return z.clamp_min(0) - z * t + torch.log1p(torch.exp(-z.abs()))


def bce_with_logits_loss(logits: torch.Tensor, targets: torch.Tensor, *, sample_weight=None
                         ) -> torch.Tensor:
    """Numerically stable BCE on logits (torch ``nn.BCEWithLogitsLoss``)."""
    return _wmean(_bce_logits_elem(at_least_f32(logits), at_least_f32(targets)), sample_weight)


def label_smoothing_bce_loss(logits: torch.Tensor, targets: torch.Tensor,
                             smoothing: float = 0.1, *, sample_weight=None) -> torch.Tensor:
    """targets -> targets * (1 - s) + 0.5 * s, then BCE with logits."""
    t = at_least_f32(targets) * (1 - smoothing) + 0.5 * smoothing
    return bce_with_logits_loss(logits, t, sample_weight=sample_weight)


def focal_bce_loss(logits: torch.Tensor, targets: torch.Tensor, alpha: float = 0.25,
                   gamma: float = 2.0, *, sample_weight=None) -> torch.Tensor:
    """Binary focal loss on logits."""
    z, t = at_least_f32(logits), at_least_f32(targets)
    ce = _bce_logits_elem(z, t)
    p = torch.sigmoid(z)
    pt = p * t + (1 - p) * (1 - t)
    a_t = alpha * t + (1 - alpha) * (1 - t)
    return _wmean(a_t * (1 - pt) ** gamma * ce, sample_weight)


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(at_least_f32(logits), dim=-1)
    return -logp.gather(-1, labels.long()[:, None])[:, 0]


def cross_entropy_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    *,
    class_weights: Optional[torch.Tensor] = None,
    sample_weight: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean CE over integer labels; the weighted sum over the sum of the
    weights with per-class and/or per-sample weights (torch semantics)."""
    nll = _nll(logits, labels)
    w = torch.ones_like(nll)
    if class_weights is not None:
        w = w * at_least_f32(class_weights)[labels.long()]
    if sample_weight is not None:
        w = w * at_least_f32(sample_weight).reshape(w.shape)
    return (w * nll).sum() / global_sum(w.sum()).clamp_min(1e-12)


def cb_focal_class_weights(samples_per_cls: Sequence[int], beta: float = 0.9999) -> torch.Tensor:
    """Class-balanced 'effective number' weights, normalised to sum to C (fp32)."""
    counts = torch.as_tensor(samples_per_cls, dtype=torch.float32)
    weights = (1.0 - beta) / (1.0 - torch.pow(torch.tensor(beta, dtype=torch.float32), counts))
    return weights / weights.sum() * counts.shape[0]


def cb_focal_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    class_weights: torch.Tensor,
    gamma: float = 2.0,
    *,
    sample_weight: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Class-balanced focal loss: per sample ``(1 - exp(-ce))**gamma * ce``
    with ``ce`` the class-weighted cross-entropy, then the (weighted) mean."""
    ce = at_least_f32(class_weights)[labels.long()] * _nll(logits, labels)
    pt = torch.exp(-ce)
    return _wmean((1 - pt) ** gamma * ce, sample_weight)


def clamp_logits(logits: torch.Tensor, limit: float = 10.0) -> torch.Tensor:
    """Clamp logits to +-limit before a BCE-style loss."""
    return logits.clamp(-limit, limit)


def align_mse_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross-modal pooled-feature alignment."""
    return ((at_least_f32(a) - at_least_f32(b)) ** 2).mean()


def temporal_smoothness_loss(tokens: torch.Tensor) -> torch.Tensor:
    """Mean squared first difference along the time axis of ``(B, T, D)``."""
    t = at_least_f32(tokens)
    if t.shape[1] <= 1:
        return t.new_zeros(())
    return ((t[:, 1:] - t[:, :-1]) ** 2).mean()


def adaptive_loss_init() -> dict:
    """The adaptive mixer's two learnable scalars, ``alpha = 0.5`` and
    ``beta = 0.3``, as fp32 parameters."""
    return {"alpha": torch.nn.Parameter(torch.tensor(0.5)),
            "beta": torch.nn.Parameter(torch.tensor(0.3))}


def adaptive_deepfake_loss(mix_params: dict, loss_cls: torch.Tensor, loss_align: torch.Tensor,
                           loss_temp: torch.Tensor) -> torch.Tensor:
    """``cls + sigmoid(alpha) * align + sigmoid(beta) * temp``."""
    return (loss_cls + torch.sigmoid(mix_params["alpha"]) * loss_align
            + torch.sigmoid(mix_params["beta"]) * loss_temp)
