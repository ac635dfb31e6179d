"""Device meshes and batch placement.

Counterpart of ``multimodal_deepfake_detection_tpu/parallel/mesh.py``. Two
shapes of multi-device run, as in JAX:

* **One process, several devices** (serving and the data-parallel eval
  CLIs): the mesh is a list of devices. :func:`auto_data_mesh` picks the
  first ``gcd(B, n)`` of them (None when that is one: score unsharded),
  :func:`replicate` puts a copy of the weights on each, and
  :func:`shard_batch` splits the rows into the contiguous blocks that JAX's
  ``P("data")`` gives, one per device. A list may name one device twice
  (``[cpu, cpu]``, ``[cuda:0, cuda:0]``): that is for tests on a host with
  one device, and changes no arithmetic of a row.
* **One process per device** (training under torchrun, the dry run): the
  mesh is a ``torch.distributed`` ``DeviceMesh`` (:func:`make_mesh`) and
  each rank takes its block of rows (:func:`data_sharding`).
"""
from __future__ import annotations

import copy
import math
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch


def local_devices(device: str = "cuda") -> List[torch.device]:
    """Every device of ``device``'s type this process sees (``cuda:0 ..
    cuda:n-1``), or the one CPU."""
    if torch.device(device).type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device(device)]


def make_mesh(axis_names: Sequence[str] = ("data",), shape: Optional[Sequence[int]] = None, *,
              device_type: str = "cuda"):
    """A ``DeviceMesh`` over the process group; by default one ``data`` axis
    spanning every rank."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axis_names))


def auto_data_mesh(batch_size: int, *, devices: Sequence[torch.device]
                   ) -> Optional[List[torch.device]]:
    """The first ``gcd(batch_size, len(devices))`` devices, or None when that
    is one device (call sites then skip sharding)."""
    n = math.gcd(batch_size, len(devices))
    return None if n <= 1 else list(devices[:n])


def data_sharding(n_shards: int, batch_size: int) -> List[slice]:
    """The contiguous row block of each of ``n_shards`` shards (``P("data")``);
    ``n_shards`` must divide ``batch_size``."""
    if batch_size % n_shards:
        raise ValueError(f"{n_shards} shards do not divide a batch of {batch_size} rows")
    b = batch_size // n_shards
    return [slice(i * b, (i + 1) * b) for i in range(n_shards)]


def shard_batch(mesh: Sequence[torch.device], arrays) -> List[tuple]:
    """Each device's block of rows of every array (numpy or tensor; None
    passes through), as tensors on that device: one tuple per device."""
    B = next(a for a in arrays if a is not None).shape[0]
    out = []
    for device, rows in zip(mesh, data_sharding(len(mesh), B)):
        out.append(tuple(None if a is None else to_device(a[rows], device) for a in arrays))
    return out


def to_device(a, device) -> torch.Tensor:
    """A numpy array or tensor on ``device``; a host array goes to CUDA
    through pinned memory, so the copy does not wait for the running work."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def map_shards(reps: Sequence, fn: Callable, arrays):
    """``fn(replica, *blocks)`` over the rows of the host ``arrays`` (batch on
    axis 0; None passes through), one contiguous block a replica, on the
    replica's ``device``. The batch is padded with zero rows (lengths 0) to a
    multiple of ``len(reps)``, every block is enqueued before any result is
    read, and the results (a tensor, or a tuple of them) come back on the
    CPU in order with the pad rows dropped. One replica is one block, as
    given."""
    B = next(a for a in arrays if a is not None).shape[0]
    pad = (-B) % len(reps)
    if pad:
        arrays = tuple(None if a is None else np.concatenate(
            [a, np.zeros((pad,) + a.shape[1:], a.dtype)]) for a in arrays)
    outs = [fn(r, *blocks)  # every device's work enqueued first
            for r, blocks in zip(reps, shard_batch([r.device for r in reps], arrays))]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat([o[i].cpu() for o in outs])[:B] for i in range(len(outs[0])))
    return torch.cat([o.cpu() for o in outs])[:B]


def replicas(obj, mesh: Sequence[torch.device], attrs: Sequence[str]) -> list:
    """``obj`` itself for the first device of ``mesh`` (``obj.device``), and
    for each further device a shallow copy of ``obj`` with its ``attrs``
    replicated there (:func:`move`) and ``device`` set to it."""
    out = [obj]
    with torch.inference_mode(False), torch.no_grad():
        for d in mesh[1:]:
            r = copy.copy(obj)
            r.device = torch.device(d)
            for attr in attrs:
                setattr(r, attr, move(getattr(obj, attr), d))
            out.append(r)
    return out


def replicate(mesh: Sequence[torch.device], obj) -> list:
    """A copy of ``obj`` (a module, a tensor, or dicts, lists and tuples of
    them; anything else is shared) on each device of ``mesh``."""
    return [move(obj, d) for d in mesh]


def move(obj, device):
    """A copy of ``obj`` on ``device`` (see :func:`replicate`)."""
    if isinstance(obj, torch.nn.Module):
        return copy.deepcopy(obj).to(device)
    if isinstance(obj, torch.Tensor):
        return obj.detach().clone().to(device)
    if isinstance(obj, dict):
        return {k: move(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(move(v, device) for v in obj)
    return obj
