"""Train and eval step builders.

Counterpart of ``multimodal_deepfake_detection_tpu/train/steps.py``. A CLI
supplies ``loss_forward`` and gets back a step that runs forward, loss,
backward, the frozen mask, the BN running-statistics update, the optimizer
and the EMA, and returns the loss and the probabilities as device tensors:
nothing in it reads a device value on the host, so the loop can enqueue the
next step before it reads this one's loss.

Freezing follows JAX, not the reference's ``requires_grad=False``: the frozen
subtrees' gradients are zeros that still go through the clip, the L2 decay
and Adam's moments, so a frozen backbone still decays under
``weight_decay``. The step only drops the frozen parameters from autograd
for the forward and backward (their gradients would be masked to zero
anyway), which skips the backbone's backward. A frozen backbone's BN keeps
batch statistics unless the CLI's forward puts it in eval mode.

``data_group`` (a process group, one rank per device, each with its block
of the batch's rows) makes a step one logical step on the global batch, as
JAX's over a data mesh: the forward runs inside
``parallel.distributed.data_parallel`` (global BN statistics, the loss as
this rank's share of the global mean), the gradients are SUM all-reduced
once after the backward (before the clip, the decay and Adam), and the step
returns the global loss and the probabilities of every rank's rows in
order. ``DistributedDataParallel`` is not used: its reducer assumes a fixed
set of parameters that require grad, and a frozen step switches them.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from ..models.xception import apply_bn_stats
from ..parallel.distributed import all_gather_rows, all_reduce_grads, data_parallel, global_sum
from .state import TrainState, ema_update


def _frozen_params(model: torch.nn.Module, frozen_keys: Sequence[str]):
    return [p for k in frozen_keys if hasattr(model, k) for p in getattr(model, k).parameters()]


def make_train_step(loss_forward: Callable, *, use_ema: bool = False,
                    ema_decay: Optional[float] = None, data_group=None):
    """``loss_forward(model, rng_seed, batch) -> (loss, (bn_stats, probs))``,
    ``bn_stats`` as ``Xception.train_forward`` gives them (applied once,
    after the backward). The step is ``step(state, batch, rng_seed,
    frozen_keys=()) -> (state, loss, probs)``; ``frozen_keys`` name
    top-level children of ``state.model``. ``data_group``: see the module
    docstring."""

    def step(state: TrainState, batch, rng_seed: int, frozen_keys: Tuple[str, ...] = ()):
        model, opt = state.model, state.optimizer
        frozen = _frozen_params(model, frozen_keys)
        for p in frozen:
            p.requires_grad_(False)
        try:
            with data_parallel(data_group):
                loss, (bn_stats, probs) = loss_forward(model, rng_seed, batch)
            opt.zero_grad()
            loss.backward()
        finally:
            for p in frozen:
                p.requires_grad_(True)
        if data_group is not None:
            all_reduce_grads(opt.params, data_group)
            loss, probs = global_sum(loss, data_group), all_gather_rows(probs, data_group)
        apply_bn_stats(bn_stats)
        # with accumulation the EMA folds in only on real optimizer steps
        if opt.step() and use_ema and state.ema is not None:
            ema_update(state.ema, model, decay=ema_decay)
        state.step += 1
        return state, loss.detach(), probs.detach()

    return step


class SwappedParams:
    """The model's parameters replaced by ``params`` (by name) for the
    ``with`` block, but those under the top-level children named in
    ``keep``."""

    def __init__(self, model: torch.nn.Module, params, keep: Sequence[str] = ()):
        self.pairs = [(p, params[n]) for n, p in model.named_parameters()
                      if n.split(".", 1)[0] not in keep]

    def __enter__(self):
        self.saved = [p.data for p, _ in self.pairs]
        for p, q in self.pairs:
            p.data = q

    def __exit__(self, *exc):
        for (p, _), d in zip(self.pairs, self.saved):
            p.data = d


def make_eval_step(eval_forward: Callable, *, use_ema_params: bool = False,
                   keep_current: Sequence[str] = (), data_group=None):
    """``eval_forward(model, batch) -> (loss, probs)`` with BN on its running
    statistics; the step ``(state, batch) -> (loss, probs)`` runs it without
    autograd, with the EMA's parameters if ``use_ema_params``, except under
    the top-level children named in ``keep_current``, which keep their
    current ones (``train_au_face`` evaluates its current ArcFace head).
    With ``data_group`` it returns the global loss and every rank's
    probabilities in order, as the train step does."""

    def run(model, batch):
        with data_parallel(data_group):
            loss, probs = eval_forward(model, batch)
        if data_group is None:
            return loss, probs
        return global_sum(loss, data_group), all_gather_rows(probs, data_group)

    @torch.no_grad()
    def step(state: TrainState, batch):
        if use_ema_params and state.ema is not None:
            with SwappedParams(state.model, state.ema.params, keep_current):
                return run(state.model, batch)
        return run(state.model, batch)

    return step
