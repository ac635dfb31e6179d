"""ctypes bindings of the native (C++) video decode engines (numpy only).

The port's copy of the JAX package's ``data/native_video.py``, with the same
functions, signatures and returns. Two engines, tried in order by
:func:`decode_video`:

* ``native/video_decode.cc`` — MJPEG-AVI: RIFF parse and libjpeg on a
  GIL-free thread pool, decode -> bilinear resize -> RGB float32 / 255 fused;
* ``native/video_decode_av.cc`` — every format libav reads (H.264 mp4 and
  the rest): decode -> ``sws_scale`` to RGB24 -> float32 / 255 into the
  batch buffer, with libavcodec's frame threading.

The libraries build at first use from ``native/`` into the package's
``build/`` (``data/native_build.py``); ``native/`` is only read.
``decode_video`` returns None for a file no engine handles, and the caller
falls back to cv2, as the reference does per file. Every clip is counted
under the engine that served it (:data:`ENGINE_COUNTS`: ``mjpeg``,
``libav``, and ``cv2`` where a caller's fallback decoded it), so a build
failure does not pass unseen as a slower cv2 run.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict, Optional, Tuple

import numpy as np

from .native_build import load_library

ENGINE_COUNTS: Dict[str, int] = {"mjpeg": 0, "libav": 0, "cv2": 0}
_count_lock = threading.Lock()


def count_engine(engine: str) -> None:
    """One more clip served by ``engine`` (``mjpeg``, ``libav`` or ``cv2``)."""
    with _count_lock:
        ENGINE_COUNTS[engine] += 1


def reset_engine_counts() -> None:
    with _count_lock:
        for k in ENGINE_COUNTS:
            ENGINE_COUNTS[k] = 0


@functools.cache
def _load_lib():
    """The MJPEG-AVI engine; ``ImportError`` when it cannot be built or loaded."""
    lib = load_library("video_decode")
    lib.vd_open.restype = ctypes.c_void_p
    lib.vd_open.argtypes = [ctypes.c_char_p]
    lib.vd_frame_count.restype = ctypes.c_int64
    lib.vd_frame_count.argtypes = [ctypes.c_void_p]
    lib.vd_width.restype = ctypes.c_int32
    lib.vd_width.argtypes = [ctypes.c_void_p]
    lib.vd_height.restype = ctypes.c_int32
    lib.vd_height.argtypes = [ctypes.c_void_p]
    lib.vd_decode_f32.restype = ctypes.c_int64
    lib.vd_decode_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int32,
    ]
    lib.vd_close.restype = None
    lib.vd_close.argtypes = [ctypes.c_void_p]
    return lib


@functools.cache
def _load_av_lib():
    """The libav engine; ``ImportError`` when it cannot be built or loaded."""
    lib = load_library("video_decode_av")
    lib.vdav_probe.restype = ctypes.c_int64
    lib.vdav_probe.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
    ]
    lib.vdav_decode_f32.restype = ctypes.c_int64
    lib.vdav_decode_f32.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int32,
    ]
    lib.vdav_encode_test.restype = ctypes.c_int64
    lib.vdav_encode_test.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_char_p,
    ]
    return lib


def encode_test_video(path: str, frames_u8: np.ndarray, *, codec: str = "libx264") -> int:
    """Write an H.264 (or the named codec's) video from ``(T, H, W, 3)`` uint8
    RGB through the system libavcodec, for tests and timings. Returns the
    packets written (<= 0 on failure); ``ImportError`` without the libav
    engine."""
    lib = _load_av_lib()
    arr = np.ascontiguousarray(frames_u8, np.uint8)
    T, H, W = arr.shape[:3]
    return int(lib.vdav_encode_test(path.encode(),
                                    arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                                    T, W, H, codec.encode()))


def native_video_available() -> bool:
    """Whether either engine builds and loads."""
    for load in (_load_lib, _load_av_lib):
        try:
            load()
            return True
        except ImportError:
            pass
    return False


def decode_video_av(path: str, *, size: Optional[Tuple[int, int]] = None,
                    max_frames: Optional[int] = None, threads: int = 0) -> Optional[np.ndarray]:
    """Decode any libav-readable video to ``(T, H, W, 3)`` float32 RGB in [0,
    1]. ``size`` is (width, height); None keeps the stream's. None on failure
    (the caller falls back)."""
    try:
        lib = _load_av_lib()
    except ImportError:
        return None
    w, h = ctypes.c_int32(0), ctypes.c_int32(0)
    est = lib.vdav_probe(path.encode(), ctypes.byref(w), ctypes.byref(h))
    if est < 0:
        return None
    cap = int(max_frames) if max_frames is not None else (int(est) if est > 0 else 100_000)
    if cap <= 0:
        return None
    out_w, out_h = (int(w.value), int(h.value)) if size is None else (int(size[0]), int(size[1]))
    if out_w <= 0 or out_h <= 0:
        return None
    out = np.empty((cap, out_h, out_w, 3), np.float32)
    got = lib.vdav_decode_f32(path.encode(), cap, out_w, out_h,
                              out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), int(threads))
    if got <= 0:
        return None
    count_engine("libav")
    return out[: int(got)]


def probe(path: str) -> Optional[Tuple[int, int, int]]:
    """``(frames, height, width)`` if the MJPEG engine opens the file, else None."""
    try:
        lib = _load_lib()
    except ImportError:
        return None
    h = lib.vd_open(path.encode())
    if not h:
        return None
    try:
        return int(lib.vd_frame_count(h)), int(lib.vd_height(h)), int(lib.vd_width(h))
    finally:
        lib.vd_close(h)


def decode_video(path: str, *, size: Optional[Tuple[int, int]] = None,
                 max_frames: Optional[int] = None, threads: int = 4) -> Optional[np.ndarray]:
    """Decode a video to ``(T, H, W, 3)`` float32 RGB in [0, 1]: the MJPEG-AVI
    engine first, then the libav engine. ``size`` is (width, height) as in
    ``cv2.resize``; None keeps the stream's. None when no engine supports the
    file (the caller falls back to cv2) or no frame decodes."""
    try:
        lib = _load_lib()
    except ImportError:
        return decode_video_av(path, size=size, max_frames=max_frames)
    h = lib.vd_open(path.encode())
    if not h:
        return decode_video_av(path, size=size, max_frames=max_frames)
    try:
        n = int(lib.vd_frame_count(h))
        if max_frames is not None:
            n = min(n, int(max_frames))
        if n == 0:
            return None
        if size is None:
            out_w, out_h = int(lib.vd_width(h)), int(lib.vd_height(h))
        else:
            out_w, out_h = int(size[0]), int(size[1])
        if out_w <= 0 or out_h <= 0:
            return None
        out = np.empty((n, out_h, out_w, 3), np.float32)
        got = lib.vd_decode_f32(h, 0, n, out_w, out_h,
                                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), int(threads))
        if got <= 0:
            return None
        count_engine("mjpeg")
        return out
    finally:
        lib.vd_close(h)
