"""What the train and test CLIs share: the device, the host-to-device copy,
the precision context, the trainers' metric loggers and resume snapshots,
and the rng of a step's dropout."""
from __future__ import annotations

import contextlib
import os

import torch

from ..core.checkpoint import load_state, save_state
from ..core.precision import ieee_fp32
from ..parallel.distributed import process_rank
from ..parallel.mesh import to_device as array_to_device


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
        return tuple(put(b) for b in a) if isinstance(a, tuple) else array_to_device(a, device)
    return tuple(put(a) for a in batch)


CKPT_BACKENDS = ("npz", "orbax")


def check_ckpt_backend(config) -> None:
    if config.ckpt_backend not in CKPT_BACKENDS:
        raise ValueError(f"--ckpt_backend {config.ckpt_backend}: one of {', '.join(CKPT_BACKENDS)}")


class ResumeState:
    """A trainer's ``--ckpt_backend`` and ``--resume``, as the JAX trainers
    handle them: ``npz`` snapshots ``<checkpoint_dir>/<name>_state.pt`` (a
    ``torch.save`` file, rank 0 alone) after each epoch and ``--resume PATH``
    loads one; ``orbax`` saves step ``epoch + 1`` into
    ``<checkpoint_dir>/<name>_orbax`` (``core/orbax_ckpt.py``) and ``--resume
    auto`` restores the newest step."""

    def __init__(self, config, name: str):
        check_ckpt_backend(config)
        self.path = os.path.join(config.checkpoint_dir, f"{name}_state.pt")
        self.orbax = None
        if config.ckpt_backend == "orbax":
            from ..core.orbax_ckpt import OrbaxStateManager

            self.orbax = OrbaxStateManager(os.path.join(config.checkpoint_dir, f"{name}_orbax"))

    def resume(self, state, resume, log) -> bool:
        """Load ``--resume`` into ``state`` in place; whether anything loaded."""
        if not resume:
            return False
        if self.orbax is not None and resume == "auto":
            if self.orbax.restore_latest(like=state) is None:
                return False
            log(f"resumed from orbax step {self.orbax.latest_step()}")
            return True
        load_state(resume, like=state)
        log(f"resumed train state from {resume} (step {state.step})")
        return True

    def save(self, state, epoch: int) -> None:
        """After ``epoch`` (0-based): every rank calls it."""
        if self.orbax is not None:
            self.orbax.save(epoch + 1, state)
        elif process_rank() == 0:
            save_state(self.path, state)


def lead_only(fn):
    """``fn`` on rank 0 of a data-parallel run (or a lone process), a no-op
    elsewhere: logs, bundles and metric sinks are written once."""
    return fn if process_rank() == 0 else (lambda *a, **k: None)


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
