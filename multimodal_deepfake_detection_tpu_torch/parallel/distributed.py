"""Process groups, the (dcn, data) mesh, and the data-parallel reductions.

Counterpart of ``multimodal_deepfake_detection_tpu/parallel/distributed.py``.
JAX runs one process per host over every local chip; the port runs one
process per device, as ``torchrun --nproc_per_node`` starts them, so
:func:`initialize` brings up ``torch.distributed`` (NCCL on CUDA, gloo on the
CPU) and returns the process's own device. A single process is a no-op, as
in JAX.

Data parallelism is explicit here, where XLA's partitioner inserts it in
JAX. A train step runs its forward inside :func:`data_parallel` (the
process group of the ``data`` axis): batch norm then normalises by the
global batch statistics (:func:`all_reduce_sum`, whose backward all-reduces
the upstream gradients, so the gradient that reaches each rank's rows is the
global one), and the losses divide their rank's weighted sum by the global
weight (:func:`global_sum`). Each rank's ``backward`` then gives its share
of the global loss's gradient, and the shares add up: the step all-reduces
the gradients with a SUM, never a mean.
"""
from __future__ import annotations

import contextlib
import contextvars
import os
import socket
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# the innermost data_parallel() group of this thread or task, if any
_DATA_GROUP = contextvars.ContextVar("data_group", default=None)


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device: str = "cuda",
) -> torch.device:
    """Join the process group and return this process's device.

    Arguments left None are read from torchrun's ``MASTER_ADDR`` /
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK``. One process
    (and no address) is a no-op that returns ``device``. ``device="cuda"``
    uses NCCL and the process's ``cuda:<local_rank>`` (raising without
    CUDA); ``"cpu"`` uses gloo. Idempotent."""
    world = num_processes if num_processes is not None else _env_int("WORLD_SIZE")
    rank = process_id if process_id is not None else _env_int("RANK")
    kind = torch.device(device).type
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r}: CUDA is not available")
    if dist.is_initialized():
        rank = dist.get_rank() if rank is None else rank
    elif world in (None, 1) and coordinator_address is None:
        return torch.device(device)
    if kind == "cuda":
        local = _env_int("LOCAL_RANK")
        local = (rank or 0) % torch.cuda.device_count() if local is None else local
        torch.cuda.set_device(local)
        own = torch.device("cuda", local)
    else:
        own = torch.device("cpu")
    if dist.is_initialized():
        return own
    if coordinator_address is not None:
        init = f"tcp://{coordinator_address}"
    elif os.environ.get("MASTER_ADDR"):
        init = "env://"
    else:
        raise ValueError("initialize: no coordinator_address and no MASTER_ADDR")
    dist.init_process_group("nccl" if kind == "cuda" else "gloo", init_method=init,
                            world_size=world, rank=rank)
    return own


def free_port() -> int:
    """A TCP port on 127.0.0.1 that is free now, for a local coordinator."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def process_rank() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def hybrid_mesh(*, dcn_data: Optional[int] = None, axis_names: Sequence[str] = ("dcn", "data")):
    """A 2-D ``DeviceMesh`` (nodes x devices a node) over the process group.

    The ``dcn`` axis spans the nodes (torchrun's ``WORLD_SIZE //
    LOCAL_WORLD_SIZE``), or ``dcn_data`` groups when given; a single node
    gives the flat ``(1, world)`` mesh, as JAX's fallback does."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    local = _env_int("LOCAL_WORLD_SIZE")
    n = dcn_data or (world // local if local else 1)
    if world % n:
        raise ValueError(f"dcn size {n} does not divide the world size {world}")
    device_type = "cuda" if dist.is_initialized() and dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n, world // n), mesh_dim_names=tuple(axis_names))


# ---------------------------------------------------------------------------
# Data-parallel reductions
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def data_parallel(group):
    """Within the block, batch norm and the losses reduce over ``group`` (a
    process group of ranks that each hold a block of the batch's rows);
    ``None`` is one process, the plain path."""
    token = _DATA_GROUP.set(group)
    try:
        yield
    finally:
        _DATA_GROUP.reset(token)


def data_group():
    """The active :func:`data_parallel` group, or None."""
    return _DATA_GROUP.get()


class _AllReduceSum(torch.autograd.Function):
    """SUM all-reduce whose backward all-reduces the upstream gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``, differentiable."""
    return _AllReduceSum.apply(x, group)


def global_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` (detached) summed over ``group`` (the active data group by
    default; ``x`` itself when there is none)."""
    group = group if group is not None else data_group()
    if group is None:
        return x
    y = x.detach().contiguous().clone()
    dist.all_reduce(y, group=group)
    return y


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' equal-sized row blocks of ``x`` concatenated in rank order."""
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts)


def all_reduce_grads(params: Sequence[torch.nn.Parameter], group) -> None:
    """SUM all-reduce of the parameters' gradients over ``group``, once, in
    one flat buffer per dtype; a DTensor's gradient reduces its local shard
    (sharded gradients stay sharded)."""
    grads = [local_tensor(p.grad) for p in params if p.grad is not None]
    for dtype in {g.dtype for g in grads}:
        gs = [g for g in grads if g.dtype == dtype]
        flat = torch.cat([g.reshape(-1) for g in gs])
        dist.all_reduce(flat, group=group)
        torch._foreach_copy_(gs, [f.view_as(g) for f, g in zip(flat.split([g.numel() for g in gs]),
                                                                 gs)])


def local_tensor(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (sharing its storage), else ``t``."""
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        with torch.no_grad():
            return t.to_local()
    return t


# ---------------------------------------------------------------------------
# A trainer's data-parallel run (one process per device, under torchrun)
# ---------------------------------------------------------------------------

_MAX_TAIL = 8  # item dims past (B, T) a batch may have, for the row exchange


class DataParallelRun:
    """This rank's place in a data-parallel trainer: the group, and the
    contiguous block of each batch's rows it computes (``P("data")``'s).
    Its loaders exchange their rows' lengths and labels over a gloo group of
    their own (host tensors, whatever the group's backend)."""

    def __init__(self, group, rank: int, world: int):
        self.group, self.rank, self.world = group, rank, world
        self.host_group = dist.new_group(backend="gloo")

    def rows(self, batch_size: int) -> slice:
        from .mesh import data_sharding

        return data_sharding(self.world, batch_size)[self.rank]

    def loader(self, loader) -> "RankRows":
        return RankRows(loader, self)

    def batch(self, batch) -> tuple:
        """A :class:`RankRows` batch ``(x, labels, lengths)`` -> this rank's
        rows of the labels and lengths too."""
        x, labels, lengths = batch
        rows = self.rows(len(labels))
        return x, labels[rows], lengths[rows]

    def assemble(self, part, b: int) -> tuple:
        """This rank's collated block ``part`` (``(x, labels, lengths)`` with
        at least its ``b`` rows first, or None: pad rows only) -> ``(x,
        labels, lengths)``: ``x`` its ``b`` rows, zero-padded on the time
        axis to the global batch's (the largest of the ranks': the bucket of
        a batch's longest item is the largest of its blocks' buckets), and
        every rank's labels and lengths in rank order. One all-gather of
        ``2 + 8 + 2b`` numbers."""
        meta = np.zeros(2 + _MAX_TAIL + 2 * b)
        meta[1] = -1  # no rows of its own
        if part is not None:
            x, labels, lengths = (np.asarray(a)[:b] for a in part)
            n, tail = len(labels), x.shape[2:]
            meta[:2 + len(tail)] = (x.shape[1], len(tail)) + tail
            meta[2 + _MAX_TAIL:2 + _MAX_TAIL + n] = lengths
            meta[2 + _MAX_TAIL + b:2 + _MAX_TAIL + b + n] = labels
        parts = [torch.empty(len(meta), dtype=torch.float64) for _ in range(self.world)]
        dist.all_gather(parts, torch.from_numpy(meta), group=self.host_group)
        every = torch.stack(parts).numpy()
        T = int(every[:, 0].max())
        if part is None:
            src = every[int(np.argmax(every[:, 1] >= 0))]
            tail = tuple(int(d) for d in src[2:2 + int(src[1])])
            x = np.zeros((b, T) + tail, np.float32)
            labels, lengths = np.zeros(b, np.float32), np.zeros(b, np.int32)
        elif x.shape[0] < b or x.shape[1] < T:
            x = np.pad(x, [(0, b - x.shape[0]), (0, T - x.shape[1])] + [(0, 0)] * (x.ndim - 2))
        lo = 2 + _MAX_TAIL
        return (x, every[:, lo + b:].reshape(-1).astype(labels.dtype),
                every[:, lo:lo + b].reshape(-1).astype(lengths.dtype))


class RankRows:
    """A batch loader (``data/loader.py::DataLoader``) that loads and
    collates this rank's rows of each batch only, so the host work of a
    step does not grow with the world size, and yields ``(x[rows], labels,
    lengths)``, the labels and lengths still the global batch's
    (:meth:`DataParallelRun.assemble`), which the train loop pairs with the
    gathered probabilities. A feature cache wrapped around it keeps this
    rank's rows only."""

    def __init__(self, loader, run: DataParallelRun):
        self.inner, self.run = loader, run
        self.dataset = loader.dataset
        self.shuffle = getattr(loader, "shuffle", False)
        loader.shard_rows(run.rows)

    def __len__(self):
        return len(self.inner)

    def __iter__(self):
        b = self.inner.batch_size // self.run.world
        for part in self.inner:
            yield self.run.assemble(part, b)


def data_parallel_run(device, batch_size: int):
    """A trainer's start: ``(its device, its DataParallelRun or None)``.

    Under torchrun with ``WORLD_SIZE`` > 1 it joins the process group
    (:func:`initialize`); a process group already up (of any size, one
    included) is used as it is. Otherwise ``(device, None)``: one process,
    no collective. The world size must divide the batch: JAX shards a batch
    over the largest mesh whose size divides it (``auto_data_mesh``'s gcd),
    but a rank cannot sit out a collective step."""
    world = _env_int("WORLD_SIZE") or 1
    if world == 1 and not dist.is_initialized():
        return torch.device(device), None
    own = initialize(device=torch.device(device).type)
    world = dist.get_world_size()
    if batch_size % world:
        raise ValueError(f"--batch_size {batch_size} does not split over {world} ranks: "
                         "JAX would shard it over gcd(batch, devices) devices, but every "
                         "rank of a data-parallel step computes a block of rows")
    return own, DataParallelRun(dist.group.WORLD, dist.get_rank(), world)
