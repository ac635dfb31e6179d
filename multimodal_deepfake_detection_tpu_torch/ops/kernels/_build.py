"""Build and load the package's CUDA sources (``csrc/``) at first use.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``build/lib<name>-<hash>.so`` inside the package
(listed in ``.gitignore``), then loaded with ``ctypes``. The hash covers every
source in ``csrc/`` and the flags, so an edited source rebuilds. Nothing here
falls back: without ``nvcc`` or a CUDA device the loader raises.
:func:`launch` is the one place a wrapper calls its kernel from.
``library.py`` registers each wrapper's CPU and CUDA implementations as a
``torch.ops.mdfd`` custom op.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)


def _find_nvcc() -> str:
    """Path of ``nvcc`` (PATH, then ``$CUDA_HOME/bin``, then /usr/local/cuda)."""
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are built from csrc/ with the CUDA toolkit"
    )


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.iterdir()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build(*names: str) -> None:
    """Compile every ``csrc/<name>.cu`` whose build is missing or stale, one
    ``nvcc`` per source, all running at once."""
    nvcc = _find_nvcc()
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the CUDA kernels need an NVIDIA GPU")
    digest = _digest()
    jobs = []
    for name in names:
        so = BUILD_DIR / f"lib{name}-{digest}.so"
        if so.exists():
            continue
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, so, tmp, proc))
    failed = []
    for name, so, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu:\n{log}")
        else:
            os.replace(tmp, so)  # atomic: concurrent builders never see a partial file
    if failed:
        raise RuntimeError("\n".join(failed))


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its build is missing or stale, then load it."""
    build(name)
    return ctypes.CDLL(str(BUILD_DIR / f"lib{name}-{_digest()}.so"))


def op_device(x: torch.Tensor) -> bool:
    """Whether a wrapper sends ``x`` through its ``torch.ops.mdfd`` op
    (``library.py``): a CPU or CUDA tensor, real or the fake one that
    ``torch.export`` traces with. A tensor on any other device goes straight
    to the CUDA implementation, whose checks raise: the op's fake kernel
    would answer a meta tensor with an empty result."""
    return x.device.type in ("cpu", "cuda")


def launch(lib: ctypes.CDLL, entry: str, x: torch.Tensor, *args) -> None:
    """Call ``lib``'s C entry point ``entry(*args, stream)`` with ``x``'s
    device current and that device's current stream; raises with the
    library's message when it returns an error. A ``ctypes`` launch goes to
    the current device, so without the guard a tensor on a second GPU would
    launch against the first GPU's context."""
    with torch.cuda.device(x.device):
        err = getattr(lib, entry)(*args, torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"{entry.removeprefix('mdfd_')} kernel failed: "
                           f"{lib.mdfd_error_string(err).decode()}")
