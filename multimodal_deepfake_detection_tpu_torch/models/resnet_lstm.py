"""AU-patch classifier with attention over the AU axis.

Counterpart of ``multimodal_deepfake_detection_tpu/models/resnet_lstm.py``:

    per-patch ResNet-18 features -> au_fc -> (B, T, A, hidden)
    attention scores (at least fp32) -> softmax over the AU axis
    optionally blended with external per-patch weights (renormalised, +1e-6)
    attended sum over A, in the compute dtype -> (B, T, hidden)
    biLSTM -> (B, T, 2 * lstm_hidden) -> (masked) mean over T -> classifier

All ``B * T * A`` patches go through the backbone as one batch; in
training (``train=True``) its BN takes batch statistics over that batch,
zero-padded frames and AUs included, as in JAX.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import torch
from torch import nn

from ..core.precision import at_least_f32
from ..ops.conv import Linear, dense
from ..ops.lstm import BiLSTM, bilstm_apply
from .resnet import FEATURE_DIM, ResNet18
from .xception import BNStats


class AUPatchClassifier(nn.Module):
    """Backbone, ``au_fc``, ``attn``, the biLSTM and the classifier: the JAX
    ``au_patch_classifier_init`` tree (``hidden_dim=128, lstm_hidden=128``)."""

    def __init__(self, hidden_dim: int = 128, lstm_hidden: int = 128, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.backbone = ResNet18(g)
        self.au_fc = Linear(FEATURE_DIM, hidden_dim, g)
        self.attn = Linear(hidden_dim, 1, g)
        self.lstm = BiLSTM(hidden_dim, lstm_hidden, g)
        self.classifier = Linear(2 * lstm_hidden, 1, g)


def attention_pool(feats: torch.Tensor, scores: torch.Tensor,
                   weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax of the ``scores (B, T, A, 1)`` (at least fp32) over the AU
    axis, blended with ``weights (B, T, A)`` as ``combined / (sum + 1e-6)``,
    then the attended sum of ``feats (B, T, A, D)`` over A in their dtype."""
    attn = torch.softmax(scores, dim=2)
    if weights is not None:
        combined = attn * at_least_f32(weights[..., None])
        attn = combined / (combined.sum(dim=2, keepdim=True) + 1e-6)
    return (attn.to(feats.dtype) * feats).sum(dim=2)


def au_patch_classifier_apply(
    model: AUPatchClassifier,
    patches: torch.Tensor,
    au_patch_weights: Optional[torch.Tensor] = None,
    *,
    lengths: Optional[torch.Tensor] = None,
    mask_padding: bool = True,
    compute_dtype: Optional[torch.dtype] = None,
    return_pooled: bool = False,
    backbone_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    train: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, BNStats]]:
    """``patches (B, T, A, H, W, 3)``, weights ``(B, T, A)`` -> logits ``(B, 1)``;
    with ``train``, ``(logits, stats)``: the backbone in batch-statistics BN
    and its statistics (``ResNet18.train_forward``).

    ``backbone_fn`` (flat ``(N, H, W, 3)`` -> ``(N, 512)``) replaces the
    eval ResNet-18: the w8a8 serving path plugs in here.

    ``lengths (B,)`` with ``mask_padding=True`` (quality mode) gates the
    biLSTM and masks the mean pool at each sample's own length, so padding
    to any width is inert; with ``mask_padding=False`` (fidelity mode) both
    run to the batch max length for every sample, the reference's
    pad-to-batch-max forward. ``lengths=None`` is the plain full-axis
    forward. ``return_pooled`` returns the (at least fp32) ``(B, 2 * lstm_hidden)``
    embedding before the classifier instead.
    """
    B, T, A = patches.shape[:3]
    flat = patches.reshape((B * T * A,) + tuple(patches.shape[3:]))
    stats: BNStats = []
    if backbone_fn is not None:
        feats = backbone_fn(flat)
    elif train:
        feats, stats = model.backbone.train_forward(flat, compute_dtype)
    else:
        feats = model.backbone(flat, compute_dtype)
    feats = dense(model.au_fc, feats, compute_dtype).reshape(B, T, A, -1)
    scores = at_least_f32(dense(model.attn, feats, compute_dtype))
    attended = attention_pool(feats, scores, au_patch_weights)

    if lengths is None:
        valid_T = None
    elif mask_padding:
        valid_T = lengths
    else:
        valid_T = lengths.max()
    lstm_out = bilstm_apply(model.lstm, attended, compute_dtype=compute_dtype, valid_T=valid_T)
    lstm_out = at_least_f32(lstm_out)
    if lengths is None:
        pooled = lstm_out.mean(dim=1)
    else:
        per_sample = lengths[:, None] if mask_padding else lengths.max().reshape(1, 1)
        mask = (torch.arange(T, device=patches.device)[None, :] < per_sample).to(lstm_out.dtype)
        pooled = ((lstm_out * mask[..., None]).sum(dim=1)
                  / mask.sum(dim=1, keepdim=True).clamp_min(1.0))
    out = pooled if return_pooled else dense(model.classifier, pooled.to(attended.dtype),
                                             compute_dtype)
    return (out, stats) if train else out
