"""Tensor-parallel parameter placements on a ``(data, model)`` mesh.

Counterpart of ``multimodal_deepfake_detection_tpu/parallel/sharding.py``:
the same rules, on the port's parameter names and torch's layouts.

* conv kernels with at least 32 output channels, divisible by the model
  size, split over their output channels: dim 0 in OIHW (and of a
  depthwise ``(C, 1, 3, 3)``), where JAX's HWIO splits dim 3; the matching
  BN scale and bias split with them;
* the MLP tower's ``w`` and ``b`` split over their output features (dim 0
  of the port's ``(out, in)`` Linear, JAX's columns), and the LSTM's
  ``w_ih`` ``(in, 4H)`` over its gate columns (dim 1, as in JAX);
* everything else is replicated.

:func:`place_params` makes the parameters DTensors, replicated over
``data`` and placed as above over ``model``. The compute does not split the
way GSPMD splits it: a forward run under :func:`gathered` all-gathers each
sharded weight at use (``full_tensor()``, whose backward hands each rank
its shard of the gradient), so the weights, their gradients and Adam's
moments are sharded at rest, and every rank of a ``model`` group computes
the whole layer on its ``data`` block. DTensor's convolution wants a
replicated weight (a ``Shard(0)`` weight fails on gloo), which rules out
its own split; the arithmetic is the single-device layer's either way.
"""
from __future__ import annotations

import contextlib
from typing import Dict

import torch
from torch import nn


def _shard_dim(name: str, shape, model_size: int):
    """The dim ``name`` splits on over ``model``, or None (replicated)."""
    if model_size <= 1:
        return None
    keys = name.split(".")
    if "fc_layers" in keys and keys[-1] in ("w", "b"):
        return 0
    if "lstm" in keys and keys[-1] == "w_ih":
        return 1
    if len(shape) == 4 and shape[0] >= 32 and shape[0] % model_size == 0:
        return 0
    if (keys[-1] in ("scale", "bias") and len(shape) == 1 and shape[0] >= 32
            and shape[0] % model_size == 0 and any(k.startswith("bn") for k in keys)):
        return 0
    return None


def param_placements(model: nn.Module, model_size: int) -> Dict[str, object]:
    """``named_parameters`` name -> its placement over the ``model`` axis
    (``Shard(dim)`` or ``Replicate()``)."""
    from torch.distributed.tensor import Replicate, Shard

    out = {}
    for name, p in model.named_parameters():
        dim = _shard_dim(name, tuple(p.shape), model_size)
        out[name] = Replicate() if dim is None else Shard(dim)
    return out


def place_params(mesh, model: nn.Module) -> nn.Module:
    """Make ``model``'s parameters DTensors on the 2-D ``("data", "model")``
    ``mesh``: replicated over ``data``, :func:`param_placements` over
    ``model`` (in place; build the optimizer after). Each rank takes its
    shard of its own copy, with no communication: every rank must hold the
    same weights (as built from one seed), as JAX's ``device_put`` of a
    host tree assumes."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    placements = param_placements(model, mesh["model"].size())
    for name, p in list(model.named_parameters()):
        mod_name, _, attr = name.rpartition(".")
        mod = model.get_submodule(mod_name)
        d = distribute_tensor(p.detach(), mesh, [Replicate(), placements[name]], src_data_rank=None)
        mod._parameters[attr] = nn.Parameter(d, requires_grad=p.requires_grad)
    return model


@contextlib.contextmanager
def gathered(model: nn.Module):
    """Within the block, each DTensor parameter of ``model`` reads as its
    whole tensor (all-gathered over its sharded mesh dims, differentiable);
    the parameters are back in place after it."""
    from torch.distributed.tensor import DTensor

    swapped = []
    for mod in model.modules():
        for attr, p in list(mod._parameters.items()):
            if isinstance(p, DTensor):
                swapped.append((mod, attr, p))
                del mod._parameters[attr]
                setattr(mod, attr, p.full_tensor())
    try:
        yield model
    finally:
        for mod, attr, p in swapped:
            delattr(mod, attr)
            mod._parameters[attr] = p
