"""What the benchmark reads from the card: its name, power limit and
clocks, CUDA-event times, launches in a captured CUDA graph, and a
``torch.profiler`` window's busy time, top device ops and idle gaps."""
from __future__ import annotations

import collections
import ctypes
import json
import os
import resource
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, List, Tuple

import numpy as np
import torch

SMI_FIELDS = ("name", "power.limit", "power.draw", "clocks.sm", "clocks.max.sm",
              "clocks.mem", "temperature.gpu")
# the active clock-limit reasons, under the name of newer drivers, then older
SMI_REASONS = ("clocks_event_reasons.active", "clocks_throttle_reasons.active")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


def smi(fields=SMI_FIELDS) -> dict:
    """``nvidia-smi``'s readings of the first card ({} without the tool)."""
    if shutil.which("nvidia-smi") is None:
        return {}
    out = subprocess.run(["nvidia-smi", f"--query-gpu={','.join(fields)}",
                          "--format=csv,noheader,nounits", "-i", "0"],
                         capture_output=True, text=True, timeout=30)
    if out.returncode != 0:
        return {"error": (out.stdout + out.stderr).strip()[:200]}
    return dict(zip(fields, (v.strip() for v in out.stdout.strip().split(","))))


def readings() -> dict:
    """The card's clocks, power, temperature and clock-limit reasons, the
    host's load average, and this process's CPU seconds and context
    switches so far: read before and after a window, they tell a run slowed
    by the card from one slowed by the host."""
    out = smi()
    for field in SMI_REASONS:
        reasons = smi((field,))
        if "error" not in reasons:
            out.update(reasons)
            break
    ru = resource.getrusage(resource.RUSAGE_SELF)
    out.update(loadavg=os.getloadavg(), cpu_user_s=ru.ru_utime, cpu_sys_s=ru.ru_stime,
               ctx_voluntary=ru.ru_nvcsw, ctx_involuntary=ru.ru_nivcsw)
    return out


def cuda_ms(fn: Callable, iters: int, warmup: int = 1) -> float:
    """Mean ms of ``fn()`` over ``iters`` calls between two CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_launches(fn: Callable) -> int:
    """The kernels one ``fn()`` launches: the kernel nodes of a CUDA graph
    captured around it (the profiler drops kernel records on the card; a
    capture keeps every launch made on the stream)."""
    fn()  # allocates and plans outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    cuda = ctypes.CDLL("libcuda.so.1")
    handle, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)

    def check(err):
        if err:
            raise RuntimeError(f"CUDA driver error {err} reading a captured graph")

    check(cuda.cuGraphGetNodes(handle, None, ctypes.byref(n)))
    nodes = (ctypes.c_void_p * n.value)()
    check(cuda.cuGraphGetNodes(handle, nodes, ctypes.byref(n)))
    kernels, kind = 0, ctypes.c_int()
    for node in nodes:
        check(cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)))
        kernels += kind.value == 0  # CU_GRAPH_NODE_TYPE_KERNEL
    graph.reset()
    return kernels


@dataclass
class Profile:
    """One profiled window: its length on the host clock, the device's busy
    time (the union of its op intervals), kernel records, the top device ops
    and the idle gaps by what the host was doing."""
    window_s: float
    busy_s: float
    kernel_records: int
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


LABELLED_GAPS = 200  # the longest gaps are named; the rest are summed apart


def _host_label(a: float, b: float, names, starts, ends) -> str:
    """The innermost host op covering at least half of the gap ``(a, b)``,
    else the one that overlaps it most."""
    over = np.flatnonzero((starts < b) & (ends > a))
    if over.size == 0:
        return "host: no op recorded"
    cover = (np.minimum(ends[over], b) - np.maximum(starts[over], a)) / (b - a)
    half = over[cover >= 0.5]
    if half.size:
        return names[half[np.argmin(ends[half] - starts[half])]]
    return names[over[np.argmax(cover)]]


def profiled(run: Callable[[], None], top: int = 10) -> Profile:
    """``run()`` under ``torch.profiler`` (CPU and CUDA activity); its chrome
    trace, written to a temporary file and removed, read back."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    dev, host, by_name, records = [], [], collections.Counter(), 0
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        s, e = float(ev["ts"]) * 1e-6, (float(ev["ts"]) + float(ev["dur"])) * 1e-6
        cat = ev.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append((s, e))
            by_name[ev["name"][:200]] += e - s
            records += cat == "kernel"
        elif cat in HOST_CATS:
            host.append((ev["name"][:200], s, e))
    merged = _union(dev)
    busy = sum(b - a for a, b in merged)
    names = [h[0] for h in host]
    starts = np.array([h[1] for h in host])
    ends = np.array([h[2] for h in host])
    between = sorted(((b - a, a, b) for (_, a), (b, _) in zip(merged, merged[1:])), reverse=True)
    gaps = collections.Counter()
    for length, a, b in between[:LABELLED_GAPS]:
        gaps[_host_label(a, b, names, starts, ends)] += length
    rest = sum(g[0] for g in between[LABELLED_GAPS:])
    if rest:
        gaps[f"gaps shorter than the {LABELLED_GAPS} longest"] += rest
    return Profile(window_s, busy, records, by_name.most_common(top), gaps.most_common(top))
