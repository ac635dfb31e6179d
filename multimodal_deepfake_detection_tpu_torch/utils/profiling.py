"""Tracing and profiling hooks.

Counterpart of ``multimodal_deepfake_detection_tpu/utils/profiling.py``:

* ``trace(logdir)``: a context manager around ``torch.profiler`` (the CPU,
  and the card where CUDA is present) that writes a TensorBoard-loadable
  trace to ``logdir`` when the block ends;
* ``annotate(name)``: a named ``torch.profiler.record_function`` region that
  shows up in those traces;
* ``StepTimer``: per-step wall timing on the host with a percentile
  summary. Work on the card is asynchronous: a timed region measures the
  device only when it ends in a ``torch.cuda.synchronize()`` or a host
  readback (``.item()``, ``.cpu()``).
"""
from __future__ import annotations

import contextlib
import time
from typing import List, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir),
    ) as prof:
        yield prof


def annotate(name: str):
    return torch.profiler.record_function(name)


class StepTimer:
    def __init__(self, name: str = "step"):
        self.name = name
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)
        return False

    def summary(self) -> str:
        if not self.times:
            return f"{self.name}: no samples"
        arr = np.asarray(self.times) * 1000
        return (
            f"{self.name}: n={len(arr)} mean={arr.mean():.2f}ms "
            f"p50={np.percentile(arr, 50):.2f}ms p95={np.percentile(arr, 95):.2f}ms "
            f"max={arr.max():.2f}ms"
        )
