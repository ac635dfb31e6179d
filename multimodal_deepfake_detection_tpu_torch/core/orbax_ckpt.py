"""Versioned, preemption-safe train-state checkpoints.

Counterpart of ``multimodal_deepfake_detection_tpu/core/orbax_ckpt.py``, with
its class name and API, on ``torch.distributed.checkpoint`` (DCP) in place
of orbax: step directories ``<dir>/<step>``, atomic finalisation (each step
is written into a hidden temporary directory, marked complete, and renamed
to its step number; a directory without the mark, or half-written, is never
restored), the newest ``max_to_keep`` steps kept, and restore in place into
a live state, DTensor placements included. Use via ``--ckpt_backend orbax``
on the train CLIs or directly:

    mgr = OrbaxStateManager(dir, max_to_keep=3)
    mgr.save(step, train_state)
    state = mgr.restore_latest(like=train_state)

The state is the model's parameters and buffers, the optimizer (its
``torch.optim`` core, the accumulation state and the counts), the EMA and
the step. Under a process group, a state that holds DTensors is saved and
loaded collectively (each rank writes its shards); a replicated one is
written by rank 0 alone and read by every rank.

The files are DCP's, not orbax's: the port cannot read the JAX package's
orbax checkpoints, nor JAX the port's. Weights cross between the packages
through ``utils/jax_weights.py``'s bundles.
"""
from __future__ import annotations

import os
import shutil
import warnings
from typing import Any, Optional

import torch
import torch.distributed as dist

_DONE = "COMMITTED"  # written last into a step directory before its rename


def _distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def _has_dtensor(tree) -> bool:
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return any(_has_dtensor(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_has_dtensor(v) for v in tree)
    return isinstance(tree, DTensor)


def _match_optimizer_state(core: torch.optim.Optimizer, saved: bool) -> None:
    """Shape ``core``'s state as the checkpoint's (DCP loads into existing
    entries only): none if the saved core had not stepped; else every
    parameter's, from one step at learning rate 0 on zero gradients, which
    leaves the parameters exactly as they are (the load then overwrites the
    state it writes)."""
    params = [p for g in core.param_groups for p in g["params"]]
    if not saved:
        core.state.clear()
        return
    if all(p in core.state for p in params):
        return
    grads = [p.grad for p in params]
    lrs = [g["lr"] for g in core.param_groups]
    for p in params:
        p.grad = torch.zeros_like(p)
    for g in core.param_groups:
        g["lr"] = 0.0
    core.step()
    for g, lr in zip(core.param_groups, lrs):
        g["lr"] = lr
    for p, grad in zip(params, grads):
        p.grad = grad


def state_dict(state) -> dict:
    """The DCP tree of a ``train.TrainState`` (tensors shared with it)."""
    opt = state.optimizer
    optim = {"core": opt.core.state_dict(), "mini_step": opt.mini_step, "count": opt.count}
    if opt.accum_steps > 1:
        optim["acc"] = opt.acc if opt.acc is not None else [
            torch.zeros_like(p) for p in opt.params]
    sd = {"step": state.step, "model": state.model.state_dict(), "optimizer": optim}
    if state.ema is not None:
        sd["ema"] = {"params": state.ema.params, "count": state.ema.count}
    return sd


class OrbaxStateManager:
    def __init__(self, directory: str, *, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = int(max_to_keep)
        os.makedirs(self.directory, exist_ok=True)

    def _lead(self) -> bool:
        return not _distributed() or dist.get_rank() == 0

    def _barrier(self) -> None:
        if _distributed():
            dist.barrier()

    def all_steps(self) -> list:
        """The finished steps, oldest first."""
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.exists(os.path.join(self.directory, d, _DONE)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any) -> None:
        step = int(step)
        sd = state_dict(state)
        tmp = os.path.join(self.directory, f".tmp-{step}")
        final = os.path.join(self.directory, str(step))
        if self._lead():
            shutil.rmtree(tmp, ignore_errors=True)
        self._barrier()
        import torch.distributed.checkpoint as dcp

        if _distributed() and _has_dtensor(sd):
            dcp.save(sd, checkpoint_id=tmp)
        elif self._lead():
            with warnings.catch_warnings():  # DCP's note that it saves in one process
                warnings.simplefilter("ignore", UserWarning)
                dcp.save(sd, checkpoint_id=tmp, no_dist=True)
        self._barrier()
        if self._lead():
            open(os.path.join(tmp, _DONE), "w").close()
            shutil.rmtree(final, ignore_errors=True)
            os.rename(tmp, final)
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)))
        self._barrier()

    def restore_latest(self, *, like: Any) -> Optional[Any]:
        """Load the newest finished step into ``like`` (a TrainState of the
        same model and optimizer layout, placements included) in place, and
        return it; None if the directory has no finished step."""
        step = self.latest_step()
        if step is None:
            return None
        import torch.distributed.checkpoint as dcp

        path = os.path.join(self.directory, str(step))
        keys = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
        _match_optimizer_state(like.optimizer.core,
                               any(k.startswith("optimizer.core.state.") for k in keys))
        sd = state_dict(like)
        if _distributed() and _has_dtensor(sd):
            dcp.load(sd, checkpoint_id=path)
        else:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)
                dcp.load(sd, checkpoint_id=path, no_dist=True)
        like.step = sd["step"]
        like.model.load_state_dict(sd["model"])
        optim = sd["optimizer"]
        like.optimizer.load_state_dict({"core": optim["core"], "mini_step": optim["mini_step"],
                                        "count": optim["count"], "acc": optim.get("acc")})
        if like.ema is not None:
            like.ema.params, like.ema.count = sd["ema"]["params"], sd["ema"]["count"]
        return like

    def close(self) -> None:
        """Nothing is pending: every save finishes before it returns."""
