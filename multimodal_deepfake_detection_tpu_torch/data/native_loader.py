"""ctypes bindings of the native (C++) npy batch collate (numpy only).

The port's copy of the JAX package's ``data/native_loader.py``.
``native/npy_collate.cc`` does the host's hot data work: npy header parse,
uint8 -> f32 / 255, zero-padded batch assembly, on native threads that
release the GIL. The library builds at first use from ``native/`` into the
package's ``build/`` (``data/native_build.py``); without ``g++`` the loader
raises ``ImportError`` and ``native_available()`` is False. MFCC clips
(float32) come out bit-equal to ``DataLoader``'s batches; uint8 frames are
scaled by ``1/255`` in C, within an ulp of numpy's ``/ 255``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import numpy as np

from .collate import bucket_length
from .loader import DataLoader
from .native_build import load_library


@functools.cache
def _load_lib():
    lib = load_library("npy_collate")
    lib.npy_shape.restype = ctypes.c_int64
    lib.npy_shape.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
    lib.collate_batch_f32.restype = ctypes.c_int64
    lib.collate_batch_f32.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int64,
    ]
    return lib


def native_available() -> bool:
    try:
        _load_lib()
        return True
    except ImportError:
        return False


def npy_shape(path: str) -> Tuple[int, ...]:
    lib = _load_lib()
    buf = (ctypes.c_int64 * 8)()
    rank = lib.npy_shape(path.encode(), buf, 8)
    if rank < 0:
        raise ValueError(f"unreadable npy: {path}")
    return tuple(buf[i] for i in range(rank))


def native_collate_paths(
    paths: Sequence[str],
    labels: Sequence[int],
    *,
    item_shape: Tuple[int, ...],
    max_t: int,
    batch_size: Optional[int] = None,
    normalize_u8: bool = True,
    num_threads: int = 4,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Load and collate npy files straight into a ``(B, max_t, *item_shape)``
    float32 batch in one C call -> ``(batch, labels (B,) float32, lengths (B,)
    int32)``. ``item_shape`` is one step's shape ((256, 256, 3) for face
    frames, (13,) for MFCC rows); rows past ``len(paths)`` stay zero."""
    lib = _load_lib()
    n = len(paths)
    B = batch_size if batch_size is not None else n
    item_elems = int(np.prod(item_shape))
    batch = np.zeros((B, max_t) + tuple(item_shape), np.float32)
    lengths = np.zeros((B,), np.int64)
    blob = b"\0".join(p.encode() for p in paths) + b"\0"
    fails = lib.collate_batch_f32(
        blob, n, batch.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), max_t, item_elems,
        1 if normalize_u8 else 0, num_threads,
    )
    if fails:
        raise IOError(f"native collate: {fails}/{n} items failed to load")
    out_labels = np.zeros((B,), np.float32)
    out_labels[:n] = np.asarray(labels, np.float32)
    return batch, out_labels, lengths.astype(np.int32)


class NativeNpyCollate:
    """The collate of :func:`make_native_loader`, bound to an
    ``NpyFolderDataset``: ``collate_indices(indices)`` loads the files of those
    indices through the C engine, padded to the bucket of their longest."""

    def __init__(self, dataset, *, buckets=None, batch_size=None, num_threads: int = 4):
        self.dataset = dataset
        self.buckets = buckets
        self.batch_size = batch_size
        self.num_threads = num_threads
        self.item_shape = npy_shape(dataset.files[0])[1:]
        if dataset.kind == "audio":
            # (T, 13) on disk; the models take (T, 3, 13)
            self.item_shape = (13,)

    def collate_indices(self, indices):
        ds = self.dataset
        paths = [ds.files[int(i)] for i in indices]
        labels = [ds.all_labels[int(i)] for i in indices]
        max_len = max(npy_shape(p)[0] for p in paths)
        if ds.max_frames is not None:
            max_len = min(max_len, ds.max_frames)
        T = bucket_length(max_len, self.buckets)
        batch, lab, lengths = native_collate_paths(
            paths, labels, item_shape=self.item_shape, max_t=T, batch_size=self.batch_size,
            normalize_u8=(ds.kind == "video"), num_threads=self.num_threads,
        )
        if ds.kind == "audio":
            batch = np.repeat(batch[:, :, None, :], 3, axis=2)  # (B, T, 3, 13)
        return batch, lab, lengths


class _IndexDataset:
    """Items are their indices; the native collate resolves them."""

    def __init__(self, ds):
        self._ds = ds
        self.all_labels = ds.all_labels

    def __len__(self):
        return len(self._ds)

    def __getitem__(self, i):
        return i


def make_native_loader(dataset, batch_size, *, buckets=None, shuffle=False, seed=0,
                       num_threads=4, prefetch=2) -> DataLoader:
    """A ``DataLoader`` over an ``NpyFolderDataset`` whose batches the C
    engine assembles: the same index order and padding as ``DataLoader(dataset,
    batch_size, buckets=buckets, shuffle=shuffle, seed=seed)``."""
    nc = NativeNpyCollate(dataset, buckets=buckets, batch_size=batch_size,
                          num_threads=num_threads)
    return DataLoader(_IndexDataset(dataset), batch_size, shuffle=shuffle, seed=seed,
                      collate=nc.collate_indices, prefetch=prefetch)
