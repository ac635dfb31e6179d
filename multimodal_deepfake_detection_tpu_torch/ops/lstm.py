"""Single-layer LSTM as an explicit time loop.

Counterpart of ``multimodal_deepfake_detection_tpu/ops/lstm.py``: the input
projection is one ``(B*T, D) @ (D, 4H)`` matmul, then a Python loop over T
runs the recurrence with h and c kept in the compute dtype, as the JAX scan
does. ``nn.LSTM`` keeps its state in fp32 and fuses the gate math, so it
rounds differently in bf16; it is deliberately not used. Gate order is
torch's ``(i, f, g, o)``; weights stay in the JAX layout ``(in, 4H)``.

``reverse`` runs the loop from the last step to the first and writes the
outputs in the original time order; ``valid_T`` gates the state update as
the JAX ``_cell_scan`` does (see :func:`lstm_apply`). :class:`BiLSTM` and
:func:`bilstm_apply` are the two directions of the AU models.
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
    params: LSTM,
    x: torch.Tensor,
    *,
    compute_dtype: Optional[torch.dtype] = None,
    reverse: bool = False,
    valid_T=None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Run the LSTM over ``(B, T, D)``; returns ``(outputs (B, T, H), (h_T, c_T))``.

    ``valid_T`` (an int, a 0-d tensor or a per-sample ``(B,)`` tensor)
    gates the carry: a step with ``t >= valid_T`` leaves h and c as they
    were and outputs the carried h. A reverse pass over a time axis padded
    past ``valid_T`` so keeps its state at zero until it reaches
    ``valid_T - 1``, as if the padding were not there. ``(h_T, c_T)`` is the
    state after the loop's last step (t = 0 when ``reverse``)."""
    B, T, _ = x.shape
    hidden = params.w_hh.shape[0]
    w_ih, w_hh = params.w_ih, params.w_hh
    bias = params.b_ih + params.b_hh
    if compute_dtype is not None:
        x, w_ih, w_hh = x.to(compute_dtype), w_ih.to(compute_dtype), w_hh.to(compute_dtype)
    # matmul then bias as two roundings, like the JAX dot + add
    x_proj = (x.reshape(B * T, -1) @ w_ih + bias.to(x.dtype)).reshape(B, T, 4 * hidden)
    keep = None
    if valid_T is not None:  # (T, B or 1, 1): whether step t updates each row
        vt = torch.as_tensor(valid_T, device=x.device).reshape(-1)
        keep = (torch.arange(T, device=x.device)[:, None] < vt[None, :])[..., None]
    h = x_proj.new_zeros((B, hidden))
    c = x_proj.new_zeros((B, hidden))
    outputs = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        gates = x_proj[:, t] + h @ w_hh
        i, f, g, o = gates.chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        if keep is not None:
            h_new = torch.where(keep[t], h_new, h)
            c_new = torch.where(keep[t], c_new, c)
        h, c = h_new, c_new
        outputs[t] = h
    return torch.stack(outputs, dim=1), (h, c)


class BiLSTM(nn.Module):
    """Two LSTM layers over the same input, ``fwd`` and ``bwd``."""

    def __init__(self, input_size: int, hidden_size: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fwd = LSTM(input_size, hidden_size, generator)
        self.bwd = LSTM(input_size, hidden_size, generator)


def bilstm_apply(params: BiLSTM, x: torch.Tensor, *, compute_dtype: Optional[torch.dtype] = None,
                 valid_T=None) -> torch.Tensor:
    """Bidirectional LSTM over ``(B, T, D)`` -> ``(B, T, 2H)``, the forward
    outputs then the backward ones. Only the backward pass is gated by
    ``valid_T``, as in the JAX package: the forward pass's outputs at
    ``t < valid_T`` never see the padding after them."""
    out_f, _ = lstm_apply(params.fwd, x, compute_dtype=compute_dtype)
    out_b, _ = lstm_apply(params.bwd, x, compute_dtype=compute_dtype, reverse=True,
                          valid_T=valid_T)
    return torch.cat([out_f, out_b], dim=-1)


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
