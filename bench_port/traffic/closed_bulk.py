"""Closed loop, one client, batches back to back.

Mix parameters: ``clips_per_call`` (B), ``lengths`` (``[lo, hi]``: each
clip's length in the engine's unit, frames or samples), ``pool`` (how many
distinct batches are made before the window; the window cycles through
them and scores each at least once). Each clip is made at its own length
and a batch is collated as the engine's serve CLI collates it. Every batch
of every seed holds the same set of lengths, evenly spaced over ``[lo,
hi]``, in another order, so a batch's longest clip, and with it the work of
a call, does not depend on the seed.

End to end: ``clips_per_s``, every clip scored over the whole window.
"""
from __future__ import annotations

import time

import numpy as np

from bench_port.records import Plan, Window


def plan(mix: dict, cfg: dict, eng, seed: int, seconds: float, device) -> Plan:
    B, pool = mix["clips_per_call"], mix["pool"]
    lo, hi = mix["lengths"]
    rng = np.random.default_rng(seed)
    lengths = np.rint(np.linspace(lo, hi, B)).astype(int)
    batches, clips = [], {}
    for k in range(pool):
        made = eng.make_clips(cfg, [int(n) for n in rng.permutation(lengths)],
                              int(rng.integers(2 ** 62)), device)
        batches.append(eng.bulk_args(made))
        clips.update({(k, i): c for i, c in enumerate(eng.scored_clips(made))})
    return Plan(clips, {"batches": batches, "clips_per_call": B})


def warm_up(p: Plan, eng, scorer) -> None:
    """Every batch of the pool once, the first twice: each shape the window
    uses, on the host and on the device."""
    batches = p.data["batches"]
    for args in [batches[0]] + batches:
        eng.bulk_call(scorer, args)


def probe_args(p: Plan, eng=None) -> tuple:
    """The calls' first batch, for the probes and the launch count."""
    return p.data["batches"][0]


def _loop(p: Plan, eng, scorer, seconds: float):
    batches, calls, answers = p.data["batches"], [], []
    t0 = time.perf_counter()
    k = 0
    while True:
        s = time.perf_counter()
        if s - t0 >= seconds and k >= len(batches):
            break
        scores = eng.bulk_call(scorer, batches[k % len(batches)])
        calls.append(time.perf_counter() - s)
        answers += [((k % len(batches), i), float(v)) for i, v in enumerate(scores)]
        k += 1
    return time.perf_counter() - t0, calls, answers


def window(p: Plan, eng, scorer, seconds: float) -> Window:
    elapsed, calls, answers = _loop(p, eng, scorer, seconds)
    q = np.percentile(np.asarray(calls) * 1e3, [10, 50, 90, 99])
    return Window(seconds=elapsed, attempted=len(answers), answers=answers, missing=[],
                  end_to_end={"clips_per_s": len(answers) / elapsed}, calls=calls,
                  info={"call_ms_p10_p50_p90_p99": [float(v) for v in q]})


def profile_run(p: Plan, eng, scorer, seconds: float):
    return lambda: _loop(p, eng, scorer, seconds)
