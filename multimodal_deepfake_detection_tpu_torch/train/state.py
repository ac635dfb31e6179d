"""The train state: step, model (its buffers are the BN state), optimizer, EMA.

Counterpart of ``multimodal_deepfake_detection_tpu/train/state.py``. The JAX
``TrainState`` is an immutable pytree threaded through a jitted step; here the
model's parameters and buffers, the optimizer's moments and the EMA are
updated in place, and the step returns the same object.

``EmaState`` is torch ``AveragedModel``'s equal-weight running average
``avg += (p - avg) / (n + 1)`` by default, exponential when a ``decay`` is
given; it averages the parameters, not the BN statistics.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn


@dataclasses.dataclass
class EmaState:
    params: Dict[str, torch.Tensor]  # averaged parameters by ``named_parameters`` name
    count: int = 0  # updates folded in


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: "Optimizer"  # noqa: F821  (train/optim.py)
    ema: Optional[EmaState] = None


def ema_init(model: nn.Module) -> EmaState:
    return EmaState({n: p.detach().clone() for n, p in model.named_parameters()})


@torch.no_grad()
def ema_update(ema: EmaState, model: nn.Module, *, decay: Optional[float] = None) -> None:
    """Equal-weight running average by default; exponential if ``decay`` given."""
    n = float(ema.count)
    for name, p in model.named_parameters():
        a = ema.params[name]
        p = p.to(a.dtype)
        a.copy_(a + (p - a) / (n + 1.0) if decay is None else decay * a + (1 - decay) * p)
    ema.count += 1
