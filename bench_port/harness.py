"""One run of one cell: set-up, the measured window, the per-layer readings
of a traced run, and the check of what the window produced.

:func:`run` returns the result line's object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device`` and, traced, ``breakdown``; the
compared numbers last, under ``compared``) and the earlier lines. It takes
no notice of where it is called from: ``run.py`` checks for the card and
prints; the tests call it on the CPU at small sizes.
"""
from __future__ import annotations

import gc
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from bench_port import device as dev
from bench_port import flops, reference, spec, weights
from bench_port.records import Plan, Window

# top-level module names the run may not have loaded: JAX and the JAX package
BANNED = ("jax", "jaxlib", "flax", "multimodal_deepfake_detection_tpu")
PROFILE_SECONDS = 2.0  # the traced run's profiled window
RATIO_CALLS = 3  # calls profiled against one call's launches in a CUDA graph


def banned_modules() -> List[str]:
    """Loaded modules whose top-level name is one of :data:`BANNED`."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def sub_seeds(seed: int) -> Dict[str, int]:
    """Independent seeds for the weights, the calibration images, the
    traffic and the check's sample, all from ``--seed``."""
    s = np.random.SeedSequence(int(seed)).generate_state(4, np.uint64)
    return dict(zip(("weights", "calibration", "traffic", "check"), (int(v >> 2) for v in s)))


@dataclass
class Cell:
    """A cell's files, by the names its workload file gives."""
    name: str
    workload: dict
    config: dict
    mix: dict
    generator: Any
    engine: Any

    @classmethod
    def load(cls, name: str, config: Optional[dict] = None, mix: Optional[dict] = None,
             workload: Optional[dict] = None) -> "Cell":
        wl = workload or spec.workload(name)
        cfg = config or spec.config(wl["config"])
        mx = mix or spec.traffic(wl["traffic"])
        return cls(name, wl, cfg, mx, spec.generator(mx["generator"]), spec.engine(cfg["engine"]))


@dataclass
class TraceContext:
    """What a per-layer reader reads (``metrics/<name>.py``'s ``read(ctx)``):
    the cell, the scorer the window drove, the window's record, the call
    arguments the probes run on (the generator's ``probe_args``), the
    profiled window, and the device."""
    cell: Cell
    scorer: Any
    window: Window
    probe_args: Optional[tuple]
    profile: Optional[dev.Profile]
    device: torch.device
    cache: Dict[str, Any] = field(default_factory=dict)

    def probe_inputs(self):
        """The probe call's inputs as ``score`` hands them to its device side,
        the backbone's images, and ``(B, T)``; computed once."""
        if "inputs" not in self.cache:
            eng = self.cell.engine
            with torch.inference_mode():
                d = eng.device_inputs(self.scorer, self.probe_args)
                x = eng.images(self.scorer, d)
            shape = eng.call_shape(self.scorer, self.probe_args)
            self.cache["inputs"] = (d, x, (shape["clips"], shape["steps"]))
        return self.cache["inputs"]

    def cuda_ms(self, fn: Callable, iters: int = 5) -> float:
        with torch.inference_mode():
            return dev.cuda_ms(fn, iters)


def _flops_per_call(cell: Cell, scorer, args) -> int:
    shape = cell.engine.call_shape(scorer, args)
    return flops.score_flops(cell.config, shape["clips"], shape["steps"])


def launch_ratio(cell: Cell, scorer, args) -> Dict[str, Any]:
    """Kernel records the profiler keeps of ``RATIO_CALLS`` calls of the
    probe call's device side, against the launches one call makes in a
    captured CUDA graph."""
    eng = cell.engine
    with torch.inference_mode():
        d = eng.device_inputs(scorer, args)
        call = lambda: scorer._score_impl(*d)
        launches = dev.graph_launches(call)

        def calls():
            for _ in range(RATIO_CALLS):
                call()

        prof = dev.profiled(calls)
    return {"graph_launches_per_call": launches,
            "profiler_records_per_call": prof.kernel_records / RATIO_CALLS,
            "records_over_launches": prof.kernel_records / (RATIO_CALLS * launches)}


LOGIT_CLAMP = 1e-6  # probabilities are clamped to [this, 1 - this] before the logit


def logit(p: np.ndarray) -> np.ndarray:
    """The logit a probability came from, the probability clamped away from 0
    and 1 (fp32 scores carry no logit past about 16)."""
    p = np.clip(p, LOGIT_CLAMP, 1 - LOGIT_CLAMP)
    return np.log(p) - np.log1p(-p)


def check(cell: Cell, plan: Plan, window: Window, seed: int, weights_of, device,
          log: Callable[[str], None]) -> tuple:
    """Every number the check computes, and the compared ones, each with its
    limit (the workload's ``check``).

    The answers the window produced are held against the plain reference's
    scores of the same clips, each clip scored alone in fp32 with TF32 off.
    The compared number, ``logit_error_vs_bf16``, is the program's mean
    squared logit error against that reference over the mean squared logit
    error of the reference itself run in bf16, the configuration's
    precision, with its BN folded as a served model's (the gauge): about 1
    for a program that computes in bf16, whatever this seed's random model
    does with rounding. The plain gaps are printed beside it.

    Every answer is compared when the window's clips number at most
    ``sample`` (a closed loop cycles a small pool); else the answers of a
    sample of clips drawn from the seed, the longest clip in it."""
    spec_check = cell.workload["check"]
    answers = window.answers
    keys = sorted({k for k, _ in answers}, key=str)
    if len(keys) > spec_check["sample"]:
        rng = np.random.default_rng(seed)
        longest = max(keys, key=lambda k: len(plan.clips[k]))
        others = [k for k in keys if k != longest]
        pick = rng.choice(len(others), spec_check["sample"] - 1, replace=False)
        keys = [longest] + [others[i] for i in sorted(pick)]
    chosen = set(keys)
    clips = [plan.clips[k] for k in keys]
    W = reference.to(weights_of(), device)
    with reference.ieee_fp32(), torch.no_grad():
        ref = dict(zip(keys, cell.engine.reference(cell.config, W, clips, device)))
        gauge = dict(zip(keys, cell.engine.reference(cell.config, W, clips, device,
                                                     torch.bfloat16)))
    del W
    got = np.array([v for k, v in answers if k in chosen])
    r = np.array([ref[k] for k, _ in answers if k in chosen])
    g = np.array([gauge[k] for k, _ in answers if k in chosen])
    err = logit(got) - logit(r)
    gauge_sq = float(np.mean((logit(g) - logit(r)) ** 2))
    spread = np.array(list(ref.values()))
    log(f"reference scores: {len(spread)} clips, mean {float(spread.mean())!r}, "
        f"std {float(spread.std())!r}, min {float(spread.min())!r}, max {float(spread.max())!r}; "
        f"logit std {float(logit(spread).std())!r}; answers compared {len(got)}")
    numbers = {"logit_error_vs_bf16": float(np.mean(err ** 2)) / gauge_sq,
               "mean_sq_logit_error": float(np.mean(err ** 2)),
               "bf16_mean_sq_logit_error": gauge_sq,
               "max_score_gap": float(np.abs(got - r).max()),
               "mean_logit_gap": float(np.abs(err).mean())}
    log(f"check numbers: {numbers}")
    return numbers, {name: {"value": numbers[name], "limit": float(lim["limit"])}
                     for name, lim in spec_check["limits"].items()}


def run(name: str, seed: int, seconds: float, trace: bool, *, t_start: float,
        device: str = "cuda", program: Optional[dict] = None,
        fault: Optional[Callable] = None, config: Optional[dict] = None,
        mix: Optional[dict] = None, workload: Optional[dict] = None,
        log: Callable[[str], None] = print) -> dict:
    """One run of cell ``name``. ``program``: serve flags that replace the
    configuration's (a control's ``quantize``); ``fault(scorer)``: breaks the
    timed path in place (the tests' planted faults); ``config``, ``mix``,
    ``workload``: replace the cell's files (the tests' small sizes)."""
    cell = Cell.load(name, config, mix, workload)
    dv = torch.device(device)
    seeds = sub_seeds(seed)
    cuda = dv.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    # set-up: weights from the seed, the engine as the CLI builds it, the
    # traffic's inputs, every shape warmed
    phases = {"start": time.perf_counter() - t_start}
    calib = cell.engine.calibration(cell.config, seeds["calibration"], dv)
    bundle = weights.make_bundle(cell.config, seeds["weights"], calib,
                                 getattr(cell.engine, "CALIBRATION_CLIPS", 1))
    del calib
    phases["weights"] = time.perf_counter() - t_start
    scorer = cell.engine.build(cell.config, bundle, dv, program)
    if fault is not None:
        fault(scorer)
    phases["engine"] = time.perf_counter() - t_start
    plan = cell.generator.plan(cell.mix, cell.config, cell.engine, seeds["traffic"], seconds, dv)
    phases["inputs"] = time.perf_counter() - t_start
    cell.generator.warm_up(plan, cell.engine, scorer)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    phases["warm_up"] = setup_s
    log("set-up, seconds from process start at the end of each phase: "
        + ", ".join(f"{k} {v!r}" for k, v in phases.items()))

    before = dev.readings() if cuda else {}
    window = cell.generator.window(plan, cell.engine, scorer, seconds)
    if cuda:
        log(f"card and host before the window: {before}; after it: {dev.readings()}")
    log(f"window: {window.seconds!r} s, {window.attempted} attempted, {window.failed} failed"
        + (f", calls {len(window.calls)}" if window.calls else "")
        + "".join(f", {k} {v!r}" for k, v in window.info.items()))

    metrics: Dict[str, dict] = {}
    breakdown = None
    device_info: Dict[str, Any] = {}
    if trace:
        profile = dev.profiled(cell.generator.profile_run(plan, cell.engine, scorer,
                                                          PROFILE_SECONDS)) if cuda else None
        args = cell.generator.probe_args(plan, cell.engine)
        ctx = TraceContext(cell, scorer, window, args, profile, dv)
        ctx.cache["flops_per_call"] = _flops_per_call(cell, scorer, args)
        if cuda:
            try:
                log(f"profiler against a CUDA graph: {launch_ratio(cell, scorer, args)}")
            except RuntimeError as e:  # a capture the call cannot make: say so, go on
                log(f"profiler against a CUDA graph: not measured ({e})")
            log(f"profiler window: {profile.window_s!r} s, busy {profile.busy_s!r} s, "
                f"kernel records {profile.kernel_records}")
            device_info.update(busy_s=profile.busy_s, window_s=profile.window_s)
            breakdown = {"device_ops": [[n, s] for n, s in profile.device_ops],
                         "idle_gaps": [[n, s] for n, s in profile.idle_gaps]}
        for mname in cell.workload["per_layer"]:
            reader = spec.metric(mname)
            value = reader.read(ctx)
            if value is not None:
                metrics[mname] = {"value": float(value), "unit": reader.UNIT}
    else:
        for mname in cell.workload["end_to_end"]:
            if mname == "setup_s":
                metrics[mname] = {"value": setup_s, "unit": "s"}
            else:
                metrics[mname] = {"value": float(window.end_to_end[mname]),
                                  "unit": cell.workload["units"][mname]}

    if cuda:
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dv)
        device_info = dict(platform="gpu", kind=torch.cuda.get_device_name(dv),
                           count=1, memory_peak_bytes=int(peak), **device_info)
        log(f"card: {dev.smi()}; memory peak {peak} bytes")
    else:
        device_info = dict(platform=dv.type, kind=dv.type, count=1, memory_peak_bytes=0,
                           **device_info)

    # the check, after the program's state is freed
    del scorer
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers, compared = check(cell, plan, window, seeds["check"],
                              lambda: reference.load(bundle), dv, log)
    correct = window.failed == 0 and all(c["value"] <= c["limit"] for c in compared.values())

    result = {"correct": bool(correct), "attempted": window.attempted, "failed": window.failed,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check_numbers"] = numbers
    result["compared"] = compared
    return result

