#!/usr/bin/env python3
"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 bench_port/run.py --workload visual-bulk --seed 7 --seconds 20 --trace 0

Run from the root of a checkout, on a machine with an NVIDIA GPU; it never
falls back to the CPU. With ``--trace 0`` it prints the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics (the same window first,
then the probes and a profiled window). Earlier lines of standard output
carry the card's readings and the run's; the last line is the result, a
JSON object. The numbers the check compared, each beside its limit, are
the last lines of standard error and the result's last key. The exit code
is 0 only when a result was printed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="bench_port/run.py", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True, help="the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from bench_port import spec

    chips = spec.workload(args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench_port: {args.workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}. No result.", file=sys.stderr)
        return 2
    from bench_port import harness

    log = lambda msg: print(f"# {msg}", flush=True)
    result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                         t_start=T_START, log=log)
    banned = harness.banned_modules()
    if banned:
        print(f"bench_port: the run loaded {banned}, which the port may not use. No result.",
              file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"compared {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
