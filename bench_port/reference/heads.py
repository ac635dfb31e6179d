"""The LSTM over per-frame features and the two heads, fp32."""
from __future__ import annotations

import torch


def lstm_last(weights: dict, feats: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """LSTM (gates i, f, g, o; ``w_ih (D, 4H)``) over ``feats (B, T, D)``, in
    the features' dtype; the output at each row's last valid step
    ``lengths - 1``."""
    dt = feats.dtype
    w_ih, w_hh = weights["model/lstm/w_ih"].to(dt), weights["model/lstm/w_hh"].to(dt)
    b = (weights["model/lstm/b_ih"].float() + weights["model/lstm/b_hh"].float()).to(dt)
    B, T, _ = feats.shape
    H = w_hh.shape[0]
    xp = feats @ w_ih + b
    h = feats.new_zeros(B, H)
    c = feats.new_zeros(B, H)
    last = feats.new_zeros(B, H)
    for t in range(T):
        i, f, g, o = (xp[:, t] + h @ w_hh).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        last = torch.where((lengths - 1 == t)[:, None], h, last)
    return last


def arcface_fake_prob(weights: dict, emb: torch.Tensor, s: float) -> torch.Tensor:
    """Softmax over ``s * cos(emb, class centre)``; the fake class's share
    (in fp32 whatever the embedding's dtype)."""
    w = weights["arcface/w"]
    emb, w = emb.float(), w.float()
    cos = (emb / emb.norm(dim=-1, keepdim=True)) @ (w / w.norm(dim=-1, keepdim=True)).T
    return torch.softmax(s * cos, dim=-1)[:, 1]


def mlp_fake_prob(weights: dict, emb: torch.Tensor) -> torch.Tensor:
    """4 x (Linear + ReLU), Linear(1) in the embedding's dtype, sigmoid in
    fp32."""
    h, dt = emb, emb.dtype
    w = lambda k: weights[k].to(dt)
    for i in range(4):
        h = torch.relu(h @ w(f"model/fc_layers/{i}/w") + w(f"model/fc_layers/{i}/b"))
    return torch.sigmoid((h @ w("model/fc_out/w") + w("model/fc_out/b")).float())[:, 0]
