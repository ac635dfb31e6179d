#!/usr/bin/env python3
"""Where the time of the separable pair (K4) goes on one NVIDIA GPU (H100).

    python3 chip_variants.py

Builds ``csrc/entry_pair.cu`` once as it is and once per variant of
``csrc/dw_gemm.cuh`` below (a copy of the sources with one change each,
under a temporary directory), then times K4's pair at the four stride-2
blocks of 256 frames at 256^2 (bf16, ``entry_pair_pallas``'s switches), in
turns, beside the first design's four launches (two K5 units: the tiled
depthwise into device memory, then the GEMM):

- ``built``: the source as it is;
- ``recompute``: past one 256-column N tile the A block is recomputed for
  each N tile instead of staying resident;
- ``no loads``: the producers read zeros instead of the unit's input;
- ``no depthwise``: the producers neither load nor sum (the MMAs, the
  pipeline and the epilogue alone).

The variants' outputs are wrong by construction; only their times count.
Prints one line per block and the sums, then the card's name, power limit
and SM clock.
"""
from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

BLOCKS = (  # (N, H, W, Cin, Cmid, Cout, leading ReLU)
    (256, 125, 125, 64, 128, 128, False),
    (256, 63, 63, 128, 256, 256, True),
    (256, 32, 32, 256, 728, 728, True),
    (256, 16, 16, 728, 728, 1024, True),
)
FAST_SUMS = "for (int p = 0; p < RUN; ++p) {\n            float acc[CH];\n            dw3x3_sum"
FAST_LOADS = "const bool inside = live && h + dy - 1 >= 0"
VARIANTS = {
    "built": [],
    "recompute": [("const bool resident = n_tiles == 1 || KT <= slots;",
                   "const bool resident = n_tiles == 1;"),
                  ("const int items = n_tiles == 1 || KT <= slots ? m_tiles : m_tiles * n_tiles;",
                   "const int items = n_tiles == 1 ? m_tiles : m_tiles * n_tiles;")],
    "no loads": [(FAST_LOADS, "const bool inside = false && h + dy - 1 >= 0")],
    "no depthwise": [(FAST_LOADS, "const bool inside = false && h + dy - 1 >= 0"),
                     (FAST_SUMS, FAST_SUMS.replace("p < RUN", "p < 0"))],
}


def build(csrc: Path, work: Path) -> dict:
    """One nvcc per variant, all at once; returns the loaded libraries."""
    from multimodal_deepfake_detection_tpu_torch.ops.kernels._build import NVCC_FLAGS, _find_nvcc

    source = (csrc / "dw_gemm.cuh").read_text()
    jobs = {}
    for name, patches in VARIANTS.items():
        text = source
        for old, new in patches:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name!r}: its anchor is gone from dw_gemm.cuh")
            text = text.replace(old, new)
        d = work / name.replace(" ", "_")
        shutil.copytree(csrc, d)
        (d / "dw_gemm.cuh").write_text(text)
        so = d / "libentry_pair.so"
        jobs[name] = (so, subprocess.Popen([_find_nvcc(), *NVCC_FLAGS, "-o", str(so),
                                            str(d / "entry_pair.cu")],
                                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                           text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name!r}:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.mdfd_entry_pair.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
        libs[name] = lib
    return libs


def main() -> int:
    import torch

    from multimodal_deepfake_detection_tpu_torch.ops.kernels._build import CSRC_DIR
    from multimodal_deepfake_detection_tpu_torch.ops.kernels.sepconv_unit import sepconv_unit

    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: chip_variants.py needs an NVIDIA GPU")
    with tempfile.TemporaryDirectory(prefix="dw_gemm_variants_") as work:
        libs = build(CSRC_DIR, Path(work))
        totals = {}
        for N, H, W, Cin, Cmid, Cout, lead in BLOCKS:
            g = torch.Generator("cuda").manual_seed(0)
            rnd = lambda *shape: torch.randn(shape, generator=g, device="cuda")
            rows = lambda k: -(-k // 32) * 32
            x = rnd(N, H, W, Cin).bfloat16()
            ops = (rnd(9, Cin), rnd(Cmid, rows(Cin)).bfloat16(), rnd(Cmid), rnd(9, Cmid),
                   rnd(Cout, rows(Cmid)).bfloat16(), rnd(Cout))
            out = torch.empty((N, H, W, Cout), dtype=torch.bfloat16, device="cuda")
            mid = torch.empty((N * H * W, Cmid), dtype=torch.bfloat16, device="cuda")
            fns = {"four launches": lambda: sepconv_unit(
                sepconv_unit(x, *ops[:3], leading_relu=lead, trailing_relu=True), *ops[3:],
                leading_relu=False, trailing_relu=False)}
            for name, lib in libs.items():
                def pair(lib=lib):
                    err = lib.mdfd_entry_pair(
                        *(t.data_ptr() for t in (x, *ops, out, mid)), N, H, W, Cin, Cmid, Cout,
                        ops[1].shape[1], ops[4].shape[1], int(lead), 1, 0, 0,
                        torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"entry_pair failed with cudaError {err}")
                fns[name] = pair
            ms = {name: [] for name in fns}
            for name in list(fns) + list(fns)[::-1]:  # in turns
                fns[name]()
                torch.cuda.synchronize()
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                for _ in range(5):
                    fns[name]()
                end.record()
                torch.cuda.synchronize()
                ms[name].append(start.elapsed_time(end) / 5)
            line = {name: sum(runs) / len(runs) for name, runs in ms.items()}
            for name, v in line.items():
                totals[name] = totals.get(name, 0.0) + v
            print(f"[chip_variants] K4 pair ({N},{H},{W},{Cin}) {Cin}->{Cmid}->{Cout}: "
                  + ", ".join(f"{k} {v:.4f} ms" for k, v in line.items()), flush=True)
        print("[chip_variants] sum over the four pairs: "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in totals.items()))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
