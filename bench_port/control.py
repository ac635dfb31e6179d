#!/usr/bin/env python3
"""The readings the check's limits are set from, on the card, in one process.

    python3 bench_port/control.py --workload visual-bulk --seeds 11,12,13 \\
        --seconds 5 [--program quantize=w8a8-pallas]

For each seed, one run of the cell as ``run.py`` makes it (set-up, a
window of ``--seconds``, the check), without timing anything that counts,
and one line ``{"seed", "program", "numbers"}`` with every number the check
can compare. ``--program flag=value`` replaces serve flags of the cell's
configuration: ``quantize=w8a8-pallas`` is the control, the port's own
int8 path, the precision below the configuration's bf16. The benchmark's
own runs never run this.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="bench_port/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--program", action="append", default=[], help="serve flag=value")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from bench_port import harness

    if not torch.cuda.is_available():
        print("control.py needs a CUDA device", file=sys.stderr)
        return 2
    program = dict(kv.split("=", 1) for kv in args.program) or None
    for seed in (int(s) for s in args.seeds.split(",")):
        result = harness.run(args.workload, seed, args.seconds, False,
                             t_start=time.perf_counter(), program=program,
                             log=lambda msg: print(f"# {msg}", flush=True))
        print(json.dumps({"workload": args.workload, "seed": seed, "program": program,
                          "numbers": result["check_numbers"], "metrics": result["metrics"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
