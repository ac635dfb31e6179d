"""Cross-modal face + AU detector.

Counterpart of ``multimodal_deepfake_detection_tpu/models/au_face.py``:

* face stream: per-frame ResNet-18 -> ``face_proj`` -> biLSTM;
* AU stream: per-patch ResNet-18 -> ``au_proj`` -> attention pool over the
  AU axis (``au_mask`` sets masked scores to -1e9, ``au_weight`` blends as
  in the AU-patch model) -> biLSTM;
* one round of single-head cross-attention each way with a residual (face
  queries the AU tokens, then the AU tokens query the updated face tokens);
* the mean-pooled concat -> ``head_fc1`` -> ReLU -> ``head_fc2``.

Videos are ``(B, T, H, W, 3)``, AU patches ``(B, Ta, A, h, w, 3)``, the mask
and weights ``(B, Ta, A)``; tokens are ``2 * lstm_hidden`` wide. In
training (``train=True``) both ResNet-18s take batch statistics, over the
``B * T`` faces and the ``B * Ta * A`` patches, padding included.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple, Union

import torch
from torch import nn

from ..core.precision import at_least_f32
from ..ops.conv import Linear, dense
from ..ops.lstm import BiLSTM, bilstm_apply
from .resnet import FEATURE_DIM, ResNet18
from .resnet_lstm import attention_pool
from .xception import BNStats

HEAD_WIDTH = 256


class AUFaceDetector(nn.Module):
    """The JAX ``au_face_detector_init`` tree (``lstm_hidden=256``: tokens of
    512, the reference's ``face_dim`` and ``au_dim``). ``num_aus`` sets no
    weight's shape, as in JAX."""

    def __init__(self, lstm_hidden: int = 256, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        g, d = generator, 2 * lstm_hidden
        self.face_backbone = ResNet18(g)
        self.au_backbone = ResNet18(g)
        self.face_proj = Linear(FEATURE_DIM, d, g)
        self.au_proj = Linear(FEATURE_DIM, d, g)
        self.au_attn = Linear(d, 1, g)
        self.face_lstm = BiLSTM(d, lstm_hidden, g)
        self.au_lstm = BiLSTM(d, lstm_hidden, g)
        self.cross_q_face = Linear(d, d, g)
        self.cross_q_au = Linear(d, d, g)
        self.head_fc1 = Linear(2 * d, HEAD_WIDTH, g)
        self.head_fc2 = Linear(HEAD_WIDTH, 1, g)


def _cross_attend(q_proj: Linear, queries: torch.Tensor, keys_values: torch.Tensor, *,
                  compute_dtype: Optional[torch.dtype], key_valid=None) -> torch.Tensor:
    """Single-head scaled dot-product cross-attention with a residual; the
    scores and the context in at least fp32. ``key_valid`` (a scalar) sets
    the keys at ``s >= key_valid`` to -inf: padded tokens are inert (0 would
    give NaN, as in JAX)."""
    q = dense(q_proj, queries, compute_dtype)
    kv = at_least_f32(keys_values)
    scores = torch.einsum("btd,bsd->bts", at_least_f32(q), kv) / math.sqrt(q.shape[-1])
    if key_valid is not None:
        valid = torch.arange(scores.shape[-1], device=scores.device) < key_valid
        scores = scores.masked_fill(~valid, float("-inf"))
    ctx = torch.einsum("bts,bsd->btd", torch.softmax(scores, dim=-1), kv)
    return queries + ctx.to(queries.dtype)


def masked_mean(tokens: torch.Tensor, valid=None) -> torch.Tensor:
    """Mean over the time axis, in at least fp32; with ``valid`` (a scalar),
    of the steps before it."""
    x = at_least_f32(tokens)
    if valid is None:
        return x.mean(dim=1)
    mask = (torch.arange(x.shape[1], device=x.device) < valid).to(x.dtype)[None, :, None]
    return (x * mask).sum(dim=1) / max(int(valid), 1)


def au_face_detector_apply(
    model: AUFaceDetector,
    videos: torch.Tensor,
    au_patches: torch.Tensor,
    au_mask: Optional[torch.Tensor] = None,
    au_weight: Optional[torch.Tensor] = None,
    *,
    v_valid: Optional[int] = None,
    au_valid: Optional[int] = None,
    compute_dtype: Optional[torch.dtype] = None,
    face_backbone_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    au_backbone_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    train: bool = False,
) -> Union[Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
           Tuple[torch.Tensor, torch.Tensor, torch.Tensor, BNStats]]:
    """-> ``(logits (B, 1), v_tokens (B, T, 2H), au_tokens (B, Ta, 2H))``;
    with ``train``, the two backbones' batch statistics after them (see
    ``ResNet18.train_forward``).

    ``v_valid`` / ``au_valid`` (ints) mark the valid prefix of each padded
    time axis: the backward scans start there, and the padded tokens leave
    the cross-attention keys and the mean pools, so the logits do not depend
    on the padding. ``None`` is the plain full-axis forward. The
    ``*_backbone_fn`` (flat ``(N, H, W, 3)`` -> ``(N, 512)``) replace the
    eval ResNet-18s: the w8a8 serving path plugs in there."""
    B, T = videos.shape[:2]
    Ta, A = au_patches.shape[1], au_patches.shape[2]
    cd = compute_dtype
    stats: BNStats = []

    def backbone(net, fn, x):
        if fn is not None:
            return fn(x)
        if train:
            feats, st = net.train_forward(x, cd)
            stats.extend(st)
            return feats
        return net(x, cd)

    frames = videos.reshape((B * T,) + tuple(videos.shape[2:]))
    f_feats = backbone(model.face_backbone, face_backbone_fn, frames)
    f_tokens = dense(model.face_proj, f_feats, cd).reshape(B, T, -1)
    v_tokens = bilstm_apply(model.face_lstm, f_tokens, compute_dtype=cd, valid_T=v_valid)

    patches = au_patches.reshape((B * Ta * A,) + tuple(au_patches.shape[3:]))
    a_feats = backbone(model.au_backbone, au_backbone_fn, patches)
    a_feats = dense(model.au_proj, a_feats, cd).reshape(B, Ta, A, -1)
    scores = at_least_f32(dense(model.au_attn, a_feats, cd))
    if au_mask is not None:
        scores = torch.where(au_mask[..., None] > 0, scores, scores.new_tensor(-1e9))
    a_pooled = attention_pool(a_feats, scores, au_weight)
    au_tokens = bilstm_apply(model.au_lstm, a_pooled, compute_dtype=cd, valid_T=au_valid)

    v_tokens = _cross_attend(model.cross_q_face, v_tokens, au_tokens, compute_dtype=cd,
                             key_valid=au_valid)
    au_tokens = _cross_attend(model.cross_q_au, au_tokens, v_tokens, compute_dtype=cd,
                              key_valid=v_valid)

    pooled = torch.cat([masked_mean(v_tokens, v_valid), masked_mean(au_tokens, au_valid)],
                       dim=-1).to(v_tokens.dtype)
    h = torch.relu(dense(model.head_fc1, pooled, cd))
    out = (dense(model.head_fc2, h, cd), v_tokens, au_tokens)
    return out + (stats,) if train else out
