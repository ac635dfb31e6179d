"""Single-layer LSTM as an explicit time loop.

Counterpart of ``multimodal_deepfake_detection_tpu/ops/lstm.py``: the input
projection is one ``(B*T, D) @ (D, 4H)`` matmul, then a Python loop over T
runs the recurrence with h and c kept in the compute dtype, as the JAX scan
does. ``nn.LSTM`` keeps its state in fp32 and fuses the gate math, so it
rounds differently in bf16; it is deliberately not used. Gate order is
torch's ``(i, f, g, o)``; weights stay in the JAX layout ``(in, 4H)``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn


class LSTM(nn.Module):
    """Weights of one LSTM layer: ``w_ih (D, 4H)``, ``w_hh (H, 4H)``, biases ``(4H,)``."""

    def __init__(self, input_size: int, hidden_size: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        bound = 1.0 / math.sqrt(hidden_size)
        u = lambda *shape: nn.Parameter((torch.rand(shape, generator=generator) * 2 - 1) * bound)
        self.w_ih = u(input_size, 4 * hidden_size)
        self.w_hh = u(hidden_size, 4 * hidden_size)
        self.b_ih = u(4 * hidden_size)
        self.b_hh = u(4 * hidden_size)


def lstm_apply(
    params: LSTM, x: torch.Tensor, *, compute_dtype: Optional[torch.dtype] = None
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Run the LSTM over ``(B, T, D)``; returns ``(outputs (B, T, H), (h_T, c_T))``."""
    B, T, _ = x.shape
    hidden = params.w_hh.shape[0]
    w_ih, w_hh = params.w_ih, params.w_hh
    bias = params.b_ih + params.b_hh
    if compute_dtype is not None:
        x, w_ih, w_hh = x.to(compute_dtype), w_ih.to(compute_dtype), w_hh.to(compute_dtype)
    # matmul then bias as two roundings, like the JAX dot + add
    x_proj = (x.reshape(B * T, -1) @ w_ih + bias.to(x.dtype)).reshape(B, T, 4 * hidden)
    h = x_proj.new_zeros((B, hidden))
    c = x_proj.new_zeros((B, hidden))
    outputs = []
    for t in range(T):
        gates = x_proj[:, t] + h @ w_hh
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        outputs.append(h)
    return torch.stack(outputs, dim=1), (h, c)


def select_last_step(
    outputs: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
    *,
    mask_padding: bool = True,
) -> torch.Tensor:
    """Pick each sequence's final LSTM output from ``(B, T, H)``.

    * ``lengths`` with ``mask_padding=True`` (quality mode): each sample's
      last valid step.
    * ``lengths`` with ``mask_padding=False`` (fidelity mode): the step at the
      batch max length for every sample — the reference's pad-consuming
      ``[:, -1]`` under pad-to-batch-max, exact under any bucket width.
    * ``lengths=None``: ``outputs[:, -1]``.
    """
    if lengths is None:
        return outputs[:, -1]
    T = outputs.shape[1]
    if mask_padding:
        idx = (lengths - 1).clamp(0, T - 1)
    else:
        idx = (lengths.max() - 1).clamp(0, T - 1).expand(lengths.shape)
    rows = torch.arange(outputs.shape[0], device=outputs.device)
    return outputs[rows, idx.long()]
