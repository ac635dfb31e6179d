"""What the train and test CLIs share: the device, the host-to-device copy,
the flags that raise, the precision context, the trainers' metric loggers
and the rng of a step's dropout."""
from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np
import torch

from ..core.precision import ieee_fp32


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: CUDA is not available (pass --device cpu "
                           "to run on the CPU)")
    return device


def to_device(batch, device: torch.device):
    """A batch of numpy arrays (tuples nest) -> the same tuples of tensors on
    ``device``; on CUDA through pinned memory, so the copy does not wait for
    the running step."""
    def put(a):
        if isinstance(a, tuple):
            return tuple(put(b) for b in a)
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)
    return tuple(put(a) for a in batch)


def raise_unported(config, not_ported: Dict[str, str]) -> None:
    """Raise ``NotImplementedError`` for each field of ``not_ported`` (name ->
    the ROADMAP item its piece waits for) that ``config`` sets away from its
    default: nothing is ignored."""
    defaults = type(config)()
    for name, item in not_ported.items():
        if getattr(config, name) != getattr(defaults, name):
            raise NotImplementedError(f"--{name} is not ported yet: it waits for {item}")


def step_generator(device: torch.device, rng_seed: int) -> torch.Generator:
    """The dropout masks' generator of one train step, on ``device``, seeded
    from the step's ``rng_seed``."""
    return torch.Generator(device=device).manual_seed(int(rng_seed))


def precision(cdtype: torch.dtype):
    """The context a CLI computes in: IEEE fp32 (TF32 off) at fp32, torch's
    own settings otherwise."""
    return ieee_fp32() if cdtype == torch.float32 else contextlib.nullcontext()


def epoch_logger(config, run_name: str):
    """The ``--jsonl_log`` and ``--tracker`` sinks of a train CLI, built as
    the JAX CLIs build them (``utils/metric_logger.py``); None when neither
    is set."""
    from ..utils.metric_logger import make_metric_logger

    specs = []
    if config.jsonl_log:
        specs.append(f"jsonl:{config.jsonl_log}")
    if config.tracker:
        specs.append(config.tracker)
    return make_metric_logger(specs, run_name=run_name, config=config)
