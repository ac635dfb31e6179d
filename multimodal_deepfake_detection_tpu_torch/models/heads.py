"""XceptionLSTM skeleton, its MLP head, the ArcFace head and the embed head.

Counterpart of ``multimodal_deepfake_detection_tpu/models/heads.py``. The
module tree has the JAX param tree's shapes (``xception_lstm_init``:
backbone, lstm, 4 fc_layers, fc_out) so a JAX bundle merges into it strictly;
visual serving uses the backbone, the LSTM and ArcFace, audio serving and
``cli/train_audio.py`` the backbone, the LSTM and the MLP head
(:func:`xception_lstm_head_apply`). :class:`XceptionLSTMArcFace` is the tree
``cli/train_visual.py`` trains, :func:`xception_lstm_features` its backbone
pass, with batch statistics in training. :class:`EmbedHead` projects the
AU-face detector's pooled tokens for ArcFace (``cli/train_au_face.py``).

Training dropout (the MLP head's keep 0.7, the embed head's keep 0.8) draws
its masks from an explicit ``torch.Generator`` on the activations' device
(:func:`dropout`); without one, or outside training, it is the identity.
The masks are not JAX's (``jax.random.bernoulli``): the same seed gives the
same mask in the port, not the same as in JAX.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.precision import at_least_f32
from ..ops.conv import Linear, dense
from ..ops.lstm import LSTM, lstm_apply, select_last_step
from ..ops.resize import resize_bilinear
from .xception import BNStats, Xception

MLP_WIDTH = 1024
FEATURE_DIM = 2048


class XceptionLSTM(nn.Module):
    """Frozen-feature Xception (no fc) -> LSTM(2048 -> hidden) -> MLP head."""

    def __init__(self, hidden_dim: int, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.backbone = Xception(num_classes=None, generator=g)
        self.lstm = LSTM(FEATURE_DIM, hidden_dim, g)
        self.fc_layers = nn.ModuleList([
            Linear(hidden_dim, MLP_WIDTH, g),
            Linear(MLP_WIDTH, MLP_WIDTH, g),
            Linear(MLP_WIDTH, MLP_WIDTH, g),
            Linear(MLP_WIDTH, MLP_WIDTH, g),
        ])
        self.fc_out = Linear(MLP_WIDTH, 1, g)


class XceptionLSTMArcFace(XceptionLSTM):
    """:class:`XceptionLSTM` with the ArcFace head as a fifth top-level
    child, ``arcface``: the JAX ``train_visual`` params tree
    ``{backbone, lstm, fc_layers, fc_out, arcface}``, whose top-level names
    the train step's ``frozen_keys`` select."""

    def __init__(self, hidden_dim: int, *, generator: Optional[torch.Generator] = None):
        super().__init__(hidden_dim, generator=generator)
        self.arcface = ArcFace(hidden_dim, 2, generator=generator)


def xception_lstm_features(model, batch: torch.Tensor, *, mode: str, train: bool = False,
                           compute_dtype: Optional[torch.dtype] = None, remat: bool = False
                           ) -> Tuple[torch.Tensor, BNStats]:
    """Per-step 2048-d backbone features ``(B, T, 2048)`` and the backbone's
    batch statistics (empty unless ``train``; see ``Xception.train_forward``).

    ``mode='video'``: ``batch`` is ``(B, T, H, W, 3)`` NHWC frames in [0, 1].
    ``mode='audio'``: ``(B, T, 3, 13)`` channel-tripled MFCC steps, each a
    ``(13, 1)`` image resized bilinearly to 64 x 64."""
    if mode == "video":
        B, T = batch.shape[:2]
        frames = batch.reshape((B * T,) + tuple(batch.shape[2:]))
    elif mode == "audio":
        B, T, C, n_mfcc = batch.shape
        frames = batch.reshape(B * T, C, n_mfcc).transpose(1, 2)[:, :, None, :]
        frames = resize_bilinear(frames, (64, 64))
    else:
        raise ValueError(f"unknown mode {mode!r}")
    if train:
        feats, stats = model.backbone.train_forward(frames, compute_dtype=compute_dtype,
                                                    remat=remat)
    else:
        feats, stats = model.backbone(frames, compute_dtype=compute_dtype), []
    return feats.reshape(B, T, FEATURE_DIM), stats


def xception_lstm_embed(head, features: torch.Tensor, *, lengths: Optional[torch.Tensor] = None,
                        mask_padding: bool = True,
                        compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The LSTM over ``features (B, T, 2048)``, then each sequence's last step
    (``select_last_step``) -> ``(B, hidden)``. ``head``: anything with the
    :class:`XceptionLSTM` head's modules (``lstm``, ``fc_layers``, ``fc_out``)."""
    outputs, _ = lstm_apply(head.lstm, features, compute_dtype=compute_dtype)
    return select_last_step(outputs, lengths, mask_padding=mask_padding)


def dropout(h: torch.Tensor, keep: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout: each element kept with probability ``keep`` (a
    uniform draw from ``generator`` below it) and scaled by ``1 / keep`` in
    ``h``'s dtype, the rest 0; the identity without a generator."""
    if generator is None:
        return h
    kept = torch.rand(h.shape, generator=generator, device=h.device) < keep
    return torch.where(kept, h / keep, torch.zeros((), dtype=h.dtype, device=h.device))


def xception_lstm_head_apply(head, features: torch.Tensor, *, train: bool = False,
                             generator: Optional[torch.Generator] = None,
                             lengths: Optional[torch.Tensor] = None, mask_padding: bool = True,
                             compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """LSTM -> last valid step -> 4 x (linear + ReLU [+ dropout]) -> ``fc_out``
    in the compute dtype -> the fp32 sigmoid probability ``(B, 1)``. With
    ``train`` and a ``generator``, dropout with keep 0.7 after each ReLU."""
    h = xception_lstm_embed(head, features, lengths=lengths, mask_padding=mask_padding,
                            compute_dtype=compute_dtype)
    for layer in head.fc_layers:
        h = torch.relu(dense(layer, h, compute_dtype))
        if train:
            h = dropout(h, 0.7, generator)
    return torch.sigmoid(at_least_f32(dense(head.fc_out, h, compute_dtype)))


class ArcFace(nn.Module):
    """Xavier-uniform ``(num_classes, feat_dim)`` class-centre weights."""

    def __init__(self, feat_dim: int, num_classes: int = 2, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        limit = math.sqrt(6.0 / (num_classes + feat_dim))
        self.w = nn.Parameter(
            (torch.rand((num_classes, feat_dim), generator=generator) * 2 - 1) * limit
        )


def arcface_apply(
    w: torch.Tensor,
    features: torch.Tensor,
    labels: Optional[torch.Tensor] = None,
    *,
    s: float = 30.0,
    m: float = 0.5,
) -> torch.Tensor:
    """Additive angular margin logits, in fp32.

    Without labels: ``s * cos(theta)``. With labels the target class logit is
    ``s * cos(theta + m)``, theta from acos clipped to ``[-1+1e-7, 1-1e-7]``.
    """
    x = at_least_f32(features)
    w = at_least_f32(w)
    x = x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    w = w / w.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    cos = x @ w.T
    if labels is None:
        return s * cos
    theta = torch.acos(cos.clamp(-1 + 1e-7, 1 - 1e-7))
    target = torch.cos(theta + m)
    one_hot = F.one_hot(labels.long(), w.shape[0]).to(cos.dtype)
    return s * (cos * (1 - one_hot) + target * one_hot)


class EmbedHead(nn.Module):
    """``fc1 (in -> 256)`` and ``fc2 (256 -> out)``: the JAX
    ``embed_head_init`` tree."""

    def __init__(self, in_dim: int, *, hidden: int = 256, out: int = 128,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc1 = Linear(in_dim, hidden, generator)
        self.fc2 = Linear(hidden, out, generator)


def embed_head_apply(head: EmbedHead, x: torch.Tensor, *, train: bool = False,
                     generator: Optional[torch.Generator] = None,
                     compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``fc1`` -> ReLU [-> dropout, keep 0.8, with ``train`` and a
    ``generator``] -> ``fc2``, in the compute dtype."""
    h = torch.relu(dense(head.fc1, x, compute_dtype))
    if train:
        h = dropout(h, 0.8, generator)
    return dense(head.fc2, h, compute_dtype)
