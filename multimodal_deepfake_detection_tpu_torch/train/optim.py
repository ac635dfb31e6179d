"""Optimizers with optax's mechanics, over ``torch.optim``.

Counterpart of ``multimodal_deepfake_detection_tpu/train/optim.py``, whose
optax chain is, in order: ``clip_by_global_norm``, the Adam / AdamW core
with an injectable learning rate, and optionally ``optax.MultiSteps``.
:class:`Optimizer` reproduces that chain around a ``torch.optim`` core:

* the clip is optax's, not ``torch.nn.utils.clip_grad_norm_``'s: gradients
  are scaled by ``max_norm / ||g||`` only when ``||g|| >= max_norm``, with no
  ``+ 1e-6`` in the divisor;
* ``adam`` with ``weight_decay`` is L2 Adam, the decay added to the clipped
  gradient (``torch.optim.Adam(weight_decay=)``); ``adamw`` is decoupled
  decay (``torch.optim.AdamW``); eps 1e-8 either way;
* ``accum_steps > 1`` averages the micro-batch gradients (``MultiSteps``,
  not torch's summing ``backward()``) and runs the clip and the core on
  every ``accum_steps``-th call only;
* the learning rate lives in ``param_groups``; a schedule sets it from the
  count of real steps before each one.

Nothing here reads a device value on the host.
"""
from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Union

import torch
import torch.distributed as dist

from ..core.precision import at_least_f32
from ..parallel.distributed import local_tensor


def _norms(grads: List[torch.Tensor]) -> List[torch.Tensor]:
    """Each gradient's L2 norm; a DTensor's over all its shards (its local
    sum of squares all-reduced over each mesh dim it is sharded on)."""
    from torch.distributed.tensor import DTensor

    if not any(isinstance(g, DTensor) for g in grads):
        return torch._foreach_norm(grads)
    out = []
    for g in grads:
        if not isinstance(g, DTensor):
            out.append(torch.linalg.vector_norm(g))
            continue
        sq = torch.linalg.vector_norm(at_least_f32(g.to_local())) ** 2
        for dim, placement in enumerate(g.placements):
            if placement.is_shard():
                dist.all_reduce(sq, group=g.device_mesh.get_group(dim))
        out.append(sq.sqrt())
    return out


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> None:
    """optax ``clip_by_global_norm``, in place (DTensor gradients too: the
    norm is the whole tensors')."""
    norm = torch.linalg.vector_norm(torch.stack([at_least_f32(n) for n in _norms(grads)]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_([local_tensor(g) for g in grads], scale)


class Optimizer:
    """``torch.optim`` core behind optax's clip and ``MultiSteps``.

    :meth:`zero_grad` gives every parameter a zero gradient (never ``None``:
    a parameter the loss does not reach, or one frozen for the step, still
    goes through the clip, the decay and the moments with a zero gradient, as
    in JAX). :meth:`step` returns whether the core stepped."""

    def __init__(self, core: torch.optim.Optimizer, *, grad_clip: Optional[float] = None,
                 accum_steps: int = 1, schedule: Optional[Callable[[int], float]] = None):
        self.core = core
        self.params = [p for g in core.param_groups for p in g["params"]]
        self.grad_clip = grad_clip
        self.accum_steps = int(accum_steps)
        self.schedule = schedule
        self.mini_step = 0  # micro-batches folded into ``acc`` so far
        self.count = 0  # the core's steps so far (the schedule's step)
        self.acc: Optional[List[torch.Tensor]] = None
        if schedule is not None:
            set_learning_rate(self, schedule(0))

    def zero_grad(self) -> None:
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        torch._foreach_zero_([p.grad for p in self.params])

    def step(self) -> bool:
        grads = [p.grad for p in self.params]
        if self.accum_steps > 1:
            if self.acc is None:
                self.acc = [torch.zeros_like(g) for g in grads]
            n = self.mini_step
            for a, g in zip(self.acc, grads):
                a.copy_(a + (g - a) / (n + 1))  # optax's running mean
            self.mini_step = (n + 1) % self.accum_steps
            if self.mini_step:
                return False
            torch._foreach_copy_(grads, self.acc)
            torch._foreach_zero_(self.acc)
        if self.grad_clip is not None:
            clip_by_global_norm_(grads, self.grad_clip)
        if self.schedule is not None:
            set_learning_rate(self, self.schedule(self.count))
        self.core.step()
        self.count += 1
        return True

    def state_dict(self) -> dict:
        return {"core": self.core.state_dict(), "mini_step": self.mini_step,
                "count": self.count, "acc": self.acc}

    def load_state_dict(self, sd: dict) -> None:
        self.core.load_state_dict(sd["core"])
        self.mini_step, self.count = sd["mini_step"], sd["count"]
        self.acc = None if sd["acc"] is None else [
            a.to(p.device) for a, p in zip(sd["acc"], self.params)]


def make_optimizer(
    params: Iterable[torch.nn.Parameter],
    name: str = "adam",
    learning_rate: Union[float, Callable[[int], float]] = 1e-4,
    *,
    weight_decay: float = 0.0,
    grad_clip: Optional[float] = None,
    accum_steps: int = 1,
) -> Optimizer:
    """``adam`` (L2 decay) or ``adamw`` (decoupled) at a fixed or scheduled LR."""
    schedule = learning_rate if callable(learning_rate) else None
    lr = schedule(0) if schedule is not None else float(learning_rate)
    if name == "adam":
        core = torch.optim.Adam(params, lr=lr, eps=1e-8, weight_decay=weight_decay)
    elif name == "adamw":
        core = torch.optim.AdamW(params, lr=lr, eps=1e-8, weight_decay=weight_decay)
    else:
        raise ValueError(f"unknown optimizer {name!r}")
    return Optimizer(core, grad_clip=grad_clip, accum_steps=accum_steps, schedule=schedule)


def get_learning_rate(opt: Optimizer) -> float:
    return float(opt.core.param_groups[0]["lr"])


def set_learning_rate(opt: Optimizer, lr: float) -> None:
    """Set the LR of every parameter group (host side, between steps)."""
    for g in opt.core.param_groups:
        g["lr"] = float(lr)
