"""Xception (arXiv:1610.02357) with live eval-mode BN, fp32, NCHW.

The block table comes from the configuration; weights from the bundle in
its JAX layouts (conv HWIO, depthwise ``(3, 3, 1, C)``), turned to OIHW
here. Stem convs have no padding, as in the model served.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F


def _w(weights: dict, key: str) -> torch.Tensor:
    return weights[key].permute(3, 2, 0, 1)  # HWIO -> OIHW


def _dw(weights: dict, key: str) -> torch.Tensor:
    w = weights[key]  # (3, 3, 1, C)
    return w.permute(3, 2, 0, 1)  # (C, 1, 3, 3)


def _bn(weights: dict, path: str, x: torch.Tensor, eps: float, observe=None) -> torch.Tensor:
    if observe is not None:
        observe(path, x)
    mean, var = weights[f"state/{path}/mean"], weights[f"state/{path}/var"]
    scale, bias = weights[f"model/{path}/scale"], weights[f"model/{path}/bias"]
    inv = scale / torch.sqrt(var + eps)
    shift = bias - mean * inv
    return x * inv.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]


def _conv_bn(weights: dict, wkey: str, path: str, x: torch.Tensor, eps: float, observe,
             folded: bool, **conv) -> torch.Tensor:
    """A conv and the BN after it: applied one after the other, or with
    ``folded`` the BN folded into the conv in fp32 first (``w * inv``,
    ``bias - mean * inv``), each then in ``x``'s dtype."""
    w = _w(weights, wkey).float()
    if not folded:
        return _bn(weights, path, F.conv2d(x, w.to(x.dtype), **conv), eps, observe)
    inv = weights[f"model/{path}/scale"] / torch.sqrt(weights[f"state/{path}/var"] + eps)
    shift = weights[f"model/{path}/bias"] - weights[f"state/{path}/mean"] * inv
    return F.conv2d(x, (w * inv[:, None, None, None]).to(x.dtype), shift.to(x.dtype), **conv)


def _sep_bn(weights: dict, path: str, bn_path: str, x: torch.Tensor, eps: float, observe,
            folded: bool) -> torch.Tensor:
    dw = _dw(weights, f"model/{path}/depthwise/w").to(x.dtype)
    h = F.conv2d(x, dw, padding=1, groups=x.shape[1])
    return _conv_bn(weights, f"model/{path}/pointwise/w", bn_path, h, eps, observe, folded)


def block_units(row):
    cin, cout, reps, _, _, grow_first = row
    if grow_first:
        return [(cin, cout)] + [(cout, cout)] * (reps - 1)
    return [(cin, cin)] * (reps - 1) + [(cin, cout)]


def features(weights: dict, cfg: dict, x_nhwc: torch.Tensor, observe=None,
             folded: bool = False) -> torch.Tensor:
    """NHWC images -> features ``(N, 2048)``, in the images' dtype (the
    weights cast to it). ``observe(path, x)``, when given, sees each BN's
    input before the BN applies (the weight maker sets the running
    statistics there). ``folded`` folds each BN into its conv in fp32 before
    the cast, as a served model does (the check's bf16 gauge)."""
    eps = cfg["bn_eps"]
    cb = functools.partial(_conv_bn, weights, eps=eps, observe=observe, folded=folded)
    sb = functools.partial(_sep_bn, weights, eps=eps, observe=observe, folded=folded)
    p = "backbone"
    x = x_nhwc.permute(0, 3, 1, 2).contiguous()
    h = torch.relu(cb(f"model/{p}/conv1/w", f"{p}/bn1", x, stride=2))
    h = torch.relu(cb(f"model/{p}/conv2/w", f"{p}/bn2", h))
    for k, row in enumerate(cfg["xception_blocks"]["rows"]):
        cin, cout, _, stride, start_with_relu, _ = row
        inp, y = h, h
        for i, _ in enumerate(block_units(row)):
            if i > 0 or start_with_relu:
                y = torch.relu(y)
            y = sb(f"{p}/blocks/{k}/units/{i}/sep", f"{p}/blocks/{k}/units/{i}/bn", y)
        if stride != 1:
            y = F.max_pool2d(y, 3, stride, 1)
        if cout != cin or stride != 1:
            skip = cb(f"model/{p}/blocks/{k}/skip/conv/w", f"{p}/blocks/{k}/skip/bn", inp,
                      stride=stride)
        else:
            skip = inp
        h = y + skip
    for n in (3, 4):
        h = torch.relu(sb(f"{p}/conv{n}", f"{p}/bn{n}", h))
    return h.float().mean(dim=(2, 3)).to(h.dtype)


def features_blocked(weights: dict, cfg: dict, images: torch.Tensor, block: int,
                     prepare=lambda x: x, folded: bool = False) -> torch.Tensor:
    """:func:`features` over ``images`` in blocks of ``block`` rows, each
    block first passed through ``prepare`` (on the weights' device)."""
    out = []
    for i in range(0, images.shape[0], block):
        out.append(features(weights, cfg, prepare(images[i: i + block]), folded=folded))
    return torch.cat(out)
