"""Build and load the repo's host-side C++ engines (``native/*.cc``) at first use.

Each engine is compiled by ``g++`` with the flags of ``native/build.sh``
into ``build/lib<name>-<hash>.so`` inside the package, the directory the
CUDA kernels build into (``ops/kernels/_build.py``, listed in
``.gitignore``), then loaded with ``ctypes``. The hash covers the source and
the flags, so an edited source rebuilds. ``native/`` itself is only read:
nothing is built or written there.

* ``npy_collate`` — npy parse, uint8 -> f32 / 255 and padded batch assembly
  on native threads (``data/native_loader.py``);
* ``video_decode`` — MJPEG-AVI over libjpeg (``data/native_video.py``);
* ``video_decode_av`` — every format libav reads, H.264 mp4 first, over
  libavformat / libavcodec / libswscale (``data/native_video.py``).

A build that fails (no ``g++``, or the host lacks libjpeg's or libav's
headers) raises ``ImportError`` with the compiler's message, and the failure
is kept for the process (:func:`build` returns it).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence

PACKAGE_DIR = Path(__file__).resolve().parents[1]
BUILD_DIR = PACKAGE_DIR / "build"
NATIVE_DIR = PACKAGE_DIR.parent / "native"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread")
LINK = {  # the engine's libraries, as native/build.sh links them
    "npy_collate": (),
    "video_decode": ("-ljpeg",),
    "video_decode_av": ("-lavformat", "-lavcodec", "-lavutil", "-lswscale"),
}
ENGINES = tuple(LINK)

_errors: Dict[str, str] = {}
# one build at a time in a process: a loader's item threads reach the
# engines together on their first clips
_lock = threading.Lock()


def library_path(name: str) -> Path:
    """Where ``native/<name>.cc`` builds: ``build/lib<name>-<hash>.so``."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + LINK[name]).encode())
    h.update((NATIVE_DIR / f"{name}.cc").read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _compile(names: Sequence[str]) -> None:
    """Compile every engine of ``names`` whose build is missing, one ``g++``
    per source, all running at once; a failure is recorded in ``_errors``."""
    gxx = shutil.which("g++")
    jobs = []
    for name in names:
        if name in _errors:
            continue
        src = NATIVE_DIR / f"{name}.cc"
        if not src.is_file():
            _errors[name] = f"{src} not found"
            continue
        so = library_path(name)
        if so.exists():
            continue
        if gxx is None:
            _errors[name] = "g++ not found"
            continue
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [gxx, *CXX_FLAGS, "-o", str(tmp), str(src), *LINK[name]]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, so, tmp, proc))
    for name, so, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            _errors[name] = f"g++ failed on native/{name}.cc:\n{log.strip()}"
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, so)  # atomic: concurrent builders never see a partial file


def build(*names: str) -> Dict[str, Optional[str]]:
    """Build the named engines (all by default) at once -> ``{name: None if
    built, else why not}``."""
    names = names or ENGINES
    with _lock:
        _compile(names)
    return {n: _errors.get(n) for n in names}


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """Build ``native/<name>.cc`` if its build is missing, then load it;
    ``ImportError`` with the reason when it cannot."""
    with _lock:
        _compile((name,))
        if name in _errors:
            raise ImportError(f"native engine {name} unavailable: {_errors[name]}")
        try:
            return ctypes.CDLL(str(library_path(name)))
        except OSError as e:
            _errors[name] = f"load failed: {e}"
            raise ImportError(f"native engine {name} unavailable: {e}") from e
