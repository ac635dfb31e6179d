#!/usr/bin/env python3
"""Where the time of the separable pair (K4) and of the middle block (K1)
goes on one NVIDIA GPU (H100).

    python3 chip_variants.py [k4] [k1] [--against DIR]

Each section builds a kernel's source once as it is and once per variant
(a copy of the sources with one change each, under a temporary directory),
one ``nvcc`` per build, all at once, and times the builds in turns. The
variants' outputs are wrong by construction where they drop work; only
their times count. With no section named, both run.

``k4``: ``csrc/entry_pair.cu`` with variants of ``csrc/dw_gemm.cuh``, K4's
pair at the four stride-2 blocks of 256 frames at 256^2 (bf16,
``entry_pair_pallas``'s switches), beside the first design's four launches
(two K5 units: the tiled depthwise into device memory, then the GEMM):

- ``built``: the source as it is;
- ``recompute``: past one 256-column N tile the A block is recomputed for
  each N tile instead of staying resident;
- ``no loads``: the producers read zeros instead of the unit's input;
- ``no depthwise``: the producers neither load nor sum (the MMAs, the
  pipeline and the epilogue alone).

``k1``: ``csrc/middle_block.cu``, one block at (256, 16, 16, 728) bf16:

- ``built``: the source as it is (the persistent GEMM of ``bf16_gemm.cuh``);
- ``one-tile GEMM``: each rep's GEMM through ``gemm::launch`` (one 128 x
  256 tile per CTA, 4 stages) with the register epilogue K1 had before its
  persistent GEMM, which loads the bias and residual and stores 4 bytes a
  thread; the depthwise as built;
- ``4 stages``: the persistent GEMM with 4 stages and a 16 KB staging
  buffer per consumer warpgroup (bf16 in two passes);
- ``no residual``: the last rep stores without the residual (no TMA load,
  no adds), so the residual's cost reads on its own;
- ``residual at k-tile 0``: the residual's TMA load issued with the tile's
  first MMAs, right after the last tile's store (which it must wait for);
- ``staging unbatched``: the depthwise keeps one staging load in flight
  per thread instead of ``DW_STAGE``;
- ``4 blocks an SM``: the depthwise's launch bound asks for 4 resident
  blocks (64 registers a thread) instead of 3;
- ``128-thread blocks``: the depthwise's blocks have 128 threads, 5
  resident, instead of 256 and 3.

Then each variant's device time per launch of each half (``torch.profiler``),
``ptxas``'s register and spill counts of the built K1 kernels, and the
shared-memory loads (``LDS``) in the depthwise's SASS. The same section
times the depthwise's other callers, K5 (conv3, conv4 of 256 frames at
8^2) and K2 (one block at K1's shape), as built, with ``one slab a
block`` (small images staged 64 channels a block instead of 128), with
``128-thread blocks``, and with the ``GEMM without epilogue`` (the
persistent GEMM's loads and MMAs alone, no residual), each half's device
time per launch.

``--against DIR``: K1 (both tap orders), K2, K5 (conv3, conv4 of 256
frames) and K4 (the four stride-2 pairs, whose GEMM epilogue is shared
with K1's) built from ``DIR``'s sources (an older checkout, say the parent
commit unpacked with ``git archive``) beside this tree's, through the
wrappers at the main path's shapes, in turns (older, this, this, older),
with each pair's outputs compared and the depthwise's ``LDS`` count of
both builds; for K2 and K5 also each build's device time per launch of
each kernel (``torch.profiler``).

Prints one line per measurement, then the card's name, power limit and SM
clock.
"""
from __future__ import annotations

import ctypes
import re
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
K4_VARIANTS = {  # name: [(file, old, new)]
    "built": [],
    "recompute": [("dw_gemm.cuh", "const bool resident = n_tiles == 1 || KT <= slots;",
                   "const bool resident = n_tiles == 1;"),
                  ("dw_gemm.cuh",
                   "const int items = n_tiles == 1 || KT <= slots ? m_tiles : m_tiles * n_tiles;",
                   "const int items = n_tiles == 1 ? m_tiles : m_tiles * n_tiles;")],
    "no loads": [("dw_gemm.cuh", FAST_LOADS, "const bool inside = false && h + dy - 1 >= 0")],
    "no depthwise": [("dw_gemm.cuh", FAST_LOADS, "const bool inside = false && h + dy - 1 >= 0"),
                     ("dw_gemm.cuh", FAST_SUMS, FAST_SUMS.replace("p < RUN", "p < 0"))],
}

# K1's rep GEMM launch as built, and the one-tile one: gemm::launch with a
# register epilogue (bias and residual loads of EPI_J column groups issued
# together, then 4-byte stores), inserted before run_block
K1_LAUNCH = """    if (int e = gemm::launch_persistent(a, ldk, pw + static_cast<size_t>(r) * C * ldk, ldk,
                                        b + static_cast<size_t>(r) * C, out, resid, M, C, C,
                                        stream))
      return e;"""
ONE_TILE_LAUNCH = """    const ResidualEpilogue<T> epi{b + static_cast<size_t>(r) * C, resid, out, M, C};
    if (int e = gemm::launch(a, ldk, pw + static_cast<size_t>(r) * C * ldk, ldk, M, C, C, epi,
                             stream))
      return e;"""
RUN_BLOCK = "template <Taps ORDER, typename T>\nint run_block("
REGISTER_EPILOGUE = """constexpr int EPI_J = 4;

template <typename T>
struct ResidualEpilogue {
  const float* bias;
  const T* resid;
  T* out;
  int M, C;
  static constexpr bool kStaged = false;

  __device__ __forceinline__ void operator()(const float* d, int row, int n0, int lane,
                                             const bf16*) const {
#pragma unroll
    for (int j0 = 0; j0 < gemm::BN / 8; j0 += EPI_J) {
      float2 bv[EPI_J], rv[EPI_J][2];
#pragma unroll
      for (int jj = 0; jj < EPI_J; ++jj) {
        const int n = n0 + (j0 + jj) * 8 + (lane & 3) * 2;
        bv[jj] = n < C ? *reinterpret_cast<const float2*>(bias + n) : make_float2(0.f, 0.f);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int m = row + half * 8;
          rv[jj][half] = resid != nullptr && n < C && m < M
                             ? load2(resid + static_cast<size_t>(m) * C + n)
                             : make_float2(0.f, 0.f);
        }
      }
#pragma unroll
      for (int jj = 0; jj < EPI_J; ++jj) {
        const int j = j0 + jj;
        const int n = n0 + j * 8 + (lane & 3) * 2;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int m = row + half * 8;
          if (n < C && m < M) {
            const float v0 = d[4 * j + 2 * half] + bv[jj].x;
            const float v1 = d[4 * j + 2 * half + 1] + bv[jj].y;
            store2(out + static_cast<size_t>(m) * C + n, v0 + rv[jj][half].x,
                   v1 + rv[jj][half].y);
          }
        }
      }
    }
  }
};

"""
K1_VARIANTS = {
    "built": [],
    "one-tile GEMM": [("middle_block.cu", K1_LAUNCH, ONE_TILE_LAUNCH),
                      ("middle_block.cu", RUN_BLOCK, REGISTER_EPILOGUE + RUN_BLOCK)],
    "4 stages": [("bf16_gemm.cuh", "constexpr int P_STAGES = 3;", "constexpr int P_STAGES = 4;"),
                 ("bf16_gemm.cuh", "constexpr int P_STAGED = 32 * 1024;",
                  "constexpr int P_STAGED = 16 * 1024;")],
    "no residual": [("middle_block.cu", "const T* resid = r + 1 == reps ? x : nullptr;",
                     "const T* resid = nullptr;")],
    "residual at k-tile 0": [("bf16_gemm.cuh", "if (kt == KT / 2 && ctid == 0 && m0 < M) {",
                              "if (kt == 0 && ctid == 0 && m0 < M) {")],
    "staging unbatched": [("sm90_common.cuh", "constexpr int DW_STAGE = 4;",
                           "constexpr int DW_STAGE = 1;")],
    "4 blocks an SM": [("sm90_common.cuh", "constexpr int DW_MIN_BLOCKS = 3;",
                        "constexpr int DW_MIN_BLOCKS = 4;")],
    "128-thread blocks": [("sm90_common.cuh", "constexpr int DW_THREADS = 256;",
                           "constexpr int DW_THREADS = 128;"),
                          ("sm90_common.cuh", "constexpr int DW_MIN_BLOCKS = 3;",
                           "constexpr int DW_MIN_BLOCKS = 5;")],
}
DW_VARIANTS = {
    "built": [],
    "one slab a block": [("sm90_common.cuh", "l->chans = whole && C > DW_CC",
                          "l->chans = false && C > DW_CC")],
    "128-thread blocks": K1_VARIANTS["128-thread blocks"],
    # the persistent GEMM's loads and MMAs alone: no epilogue, no residual
    "GEMM without epilogue": [
        ("bf16_gemm.cuh", "    store_tile<T, RELU_OUT, P_STAGED, RESID>(d, &map_out,",
         "    if (M < 0) store_tile<T, RELU_OUT, P_STAGED, RESID>(d, &map_out,"),
        ("middle_block_w8.cu", "const T* resid = r + 1 == reps ? x : nullptr;",
         "const T* resid = nullptr;")],
}
K1_SHAPE = (256, 16, 728, 736)  # N, H = W, C, the packed weight's row length
BOUNDS_US = "depthwise 57.3, GEMM 70.2 (reps 0-1) and 86.1 (rep 2) us"  # PERF.md §6


def patched_copy(csrc: Path, work: Path, tag: str, patches) -> Path:
    """A copy of ``csrc`` under ``work/tag`` with each ``(file, old, new)``
    applied; every ``old`` must occur exactly once."""
    d = work / re.sub(r"\W+", "_", tag)
    shutil.copytree(csrc, d)
    for file, old, new in patches:
        text = (d / file).read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"variant {tag!r}: its anchor is gone from {file}")
        (d / file).write_text(text.replace(old, new))
    return d


def compile_all(jobs: dict, verbose: bool = False) -> dict:
    """``{key: (csrc dir, source stem)}`` -> ``{key: (library path, nvcc log)}``;
    one nvcc per job, all at once."""
    from multimodal_deepfake_detection_tpu_torch.ops.kernels._build import NVCC_FLAGS, _find_nvcc

    procs = {}
    for key, (d, stem) in jobs.items():
        so = d / f"lib{stem}.so"
        extra = ["-Xptxas", "-v"] if verbose else []
        procs[key] = (so, subprocess.Popen([_find_nvcc(), *NVCC_FLAGS, *extra, "-o", str(so),
                                            str(d / f"{stem}.cu")],
                                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                           text=True))
    built = {}
    for key, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {key!r}:\n{log}")
        built[key] = (so, log)
    return built


def in_turns(torch, fns: dict, iters: int) -> dict:
    """Mean ms per call of each callable, timed in turns (a b ... b a)."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    ms = {name: [] for name in fns}
    for name in list(fns) + list(fns)[::-1]:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(iters):
            fns[name]()
        end.record()
        torch.cuda.synchronize()
        ms[name].append(start.elapsed_time(end) / iters)
    return {name: sum(runs) / len(runs) for name, runs in ms.items()}


def section_k4(torch, work: Path, csrc: Path) -> None:
    from multimodal_deepfake_detection_tpu_torch.ops.kernels.sepconv_unit import sepconv_unit

    built = compile_all({name: (patched_copy(csrc, work, "k4 " + name, patches), "entry_pair")
                         for name, patches in K4_VARIANTS.items()})
    libs = {}
    for name, (so, _) in built.items():
        lib = ctypes.CDLL(str(so))
        lib.mdfd_entry_pair.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
        libs[name] = lib
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
        line = in_turns(torch, fns, 5)
        for name, v in line.items():
            totals[name] = totals.get(name, 0.0) + v
        print(f"[chip_variants] K4 pair ({N},{H},{W},{Cin}) {Cin}->{Cmid}->{Cout}: "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in line.items()), flush=True)
    print("[chip_variants] K4 sum over the four pairs: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in totals.items()), flush=True)


def wrapper_lib(module, so: Path) -> ctypes.CDLL:
    """The library at ``so`` set up as the wrapper ``module``'s ``_lib()``
    sets up its own."""
    saved = module.load_library
    module.load_library = lambda name: ctypes.CDLL(str(so))
    try:
        return module._lib.__wrapped__()
    finally:
        module.load_library = saved


def through(module, lib, fn):
    """``fn`` with the wrapper ``module`` launching from ``lib``."""
    def call():
        saved = module._lib
        module._lib = lambda: lib
        try:
            return fn()
        finally:
            module._lib = saved
    return call


def device_us(torch, fn) -> dict:
    """Device time per launch (us) and launches of each kernel of one ``fn()``."""
    import chip_smoke

    return {key: (us / n, round(n / chip_smoke.PROFILED_CALLS))
            for key, (us, n) in chip_smoke.device_kernels(torch, fn).items()}


def lds_count(so: Path) -> dict:
    """Shared-memory loads (LDS) in the SASS of each depthwise kernel of ``so``."""
    from multimodal_deepfake_detection_tpu_torch.ops.kernels._build import _find_nvcc

    sass = subprocess.run([str(Path(_find_nvcc()).with_name("cuobjdump")), "-sass", str(so)],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
        elif fn and "dw3x3_relu_kernel" in fn and re.search(r"\bLDS(\.\S+)?\s", line):
            counts[fn] = counts.get(fn, 0) + 1
    return counts


def ptxas_lines(log: str, keys=("persistent_kernel", "gemm_kernel", "dw3x3_relu_kernel")):
    """``ptxas -v``'s register and spill lines of the kernels named by ``keys``."""
    out, fn = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
        elif fn and any(k in fn for k in keys) and ("registers" in line or "spill" in line):
            out.append(f"{next(k for k in keys if k in fn)} ({fn[-24:]}): {line.strip()}")
    return out


def section_k1(torch, work: Path, csrc: Path) -> None:
    import chip_smoke
    from multimodal_deepfake_detection_tpu_torch.ops.kernels import middle_block as mb

    built = compile_all({name: (patched_copy(csrc, work, "k1 " + name, patches), "middle_block")
                         for name, patches in K1_VARIANTS.items()}, verbose=True)
    for line in ptxas_lines(built["built"][1]):
        print(f"[chip_variants] K1 ptxas: {line}", flush=True)
    for fn, n in lds_count(built["built"][0]).items():
        print(f"[chip_variants] K1 depthwise LDS in the SASS: {n} in {fn[:100]}", flush=True)
    libs = {name: wrapper_lib(mb, so) for name, (so, _) in built.items()}
    N, H, C, ldk = K1_SHAPE
    x, dw, pw, b = chip_smoke.k1_operands(torch, N, H, C, "bfloat16", ldk, seed=99)
    fns = {name: through(mb, lib, lambda: mb.middle_block(x, dw, pw, b))
           for name, lib in libs.items()}
    line = in_turns(torch, fns, 10)
    print(f"[chip_variants] K1 block ({N},{H},{H},{C}) bf16: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in line.items()), flush=True)
    for name in fns:
        per = device_us(torch, fns[name])
        print(f"[chip_variants] K1 {name}, device us per launch (launches per block): "
              + "; ".join(f"{k[:60]} {us:.2f} (x{n})" for k, (us, n) in per.items())
              + f" [bounds: {BOUNDS_US}]", flush=True)
    section_dw(torch, work, csrc)


def section_dw(torch, work: Path, csrc: Path) -> None:
    """K5 and K2, the depthwise's other callers, per DW_VARIANTS, in turns,
    with each half's device time per launch."""
    import chip_smoke
    from multimodal_deepfake_detection_tpu_torch.ops.kernels import middle_block_w8 as mb8
    from multimodal_deepfake_detection_tpu_torch.ops.kernels import sepconv_unit as su

    jobs = {}
    for name, patches in DW_VARIANTS.items():
        d = patched_copy(csrc, work, "dw " + name, patches)
        jobs[(name, "K5")] = (d, "sepconv_unit")
        jobs[(name, "K2")] = (d, "middle_block_w8")
    built = compile_all(jobs)
    modules = {"K5": su, "K2": mb8}
    libs = {key: wrapper_lib(modules[key[1]], so) for key, (so, _) in built.items()}
    N, H, C, _ = K1_SHAPE
    k2 = chip_smoke.k2_operands(torch, N, H, C, "bfloat16", seed=100)
    cases = {"K2": ("K2", lambda: mb8.middle_block_w8(*k2))}
    for i, (Nc, Hc, Cin, Cout, lead, trail, dtype) in enumerate(chip_smoke.K5_CONVS):
        ops = chip_smoke.k5_operands(torch, Nc, Hc, Cin, Cout, dtype, seed=700 + i)
        kw = dict(leading_relu=lead, trailing_relu=trail)
        cases[f"K5 conv{3 + i}"] = ("K5", lambda ops=ops, kw=kw: su.sepconv_unit(*ops, **kw))
    for label, (k, fn) in cases.items():
        fns = {name: through(modules[k], libs[(name, k)], fn) for name in DW_VARIANTS}
        line = in_turns(torch, fns, 10)
        per = {name: device_us(torch, f) for name, f in fns.items()}
        halves = {name: "; ".join(f"{'depthwise' if 'dw3x3' in key else 'GEMM'} {us:.2f} us x{n}"
                                  for key, (us, n) in per[name].items()
                                  if "dw3x3" in key or "persistent_kernel" in key)
                  for name in fns}
        print(f"[chip_variants] {label}: " + ", ".join(
            f"{name} {line[name]:.4f} ms ({halves[name]})" for name in fns), flush=True)


def section_against(torch, work: Path, csrc: Path, older: Path) -> None:
    import chip_smoke
    from multimodal_deepfake_detection_tpu_torch.ops.kernels import entry_pair as ep
    from multimodal_deepfake_detection_tpu_torch.ops.kernels import middle_block as mb
    from multimodal_deepfake_detection_tpu_torch.ops.kernels import middle_block_w8 as mb8
    from multimodal_deepfake_detection_tpu_torch.ops.kernels import sepconv_unit as su

    stems = {"K1": "middle_block", "K2": "middle_block_w8", "K5": "sepconv_unit",
             "K4": "entry_pair"}
    jobs = {}
    for tag, d in (("older", older), ("this", csrc)):
        copy = patched_copy(d, work, "against " + tag, [])
        for k, stem in stems.items():
            jobs[(tag, k)] = (copy, stem)
    built = compile_all(jobs)
    for tag in ("older", "this"):
        for fn, n in lds_count(built[(tag, "K1")][0]).items():
            print(f"[chip_variants] {tag} depthwise LDS in the SASS: {n} in {fn[:100]}", flush=True)
    modules = {"K1": mb, "K2": mb8, "K5": su, "K4": ep}
    libs = {key: wrapper_lib(modules[key[1]], so) for key, (so, _) in built.items()}
    N, H, C, ldk = K1_SHAPE
    k1 = chip_smoke.k1_operands(torch, N, H, C, "bfloat16", ldk, seed=0)
    k2 = chip_smoke.k2_operands(torch, N, H, C, "bfloat16", seed=100)
    cases = {
        "K1 fp32 taps": ("K1", lambda: mb.middle_block(*k1)),
        "K1 bf16 taps": ("K1", lambda: mb.middle_block(*k1, taps="bf16")),
        "K2": ("K2", lambda: mb8.middle_block_w8(*k2)),
    }
    for i, (Nc, Hc, Cin, Cout, lead, trail, dtype) in enumerate(chip_smoke.K5_CONVS):
        ops = chip_smoke.k5_operands(torch, Nc, Hc, Cin, Cout, dtype, seed=700 + i)
        kw = dict(leading_relu=lead, trailing_relu=trail)
        cases[f"K5 conv{3 + i}"] = ("K5", lambda ops=ops, kw=kw: su.sepconv_unit(*ops, **kw))
    for i, (Nb, Hb, Wb, Cin, Cmid, Cout, lead, dtype) in enumerate(chip_smoke.K3_BLOCKS):
        ops = chip_smoke.k3_operands(torch, Nb, Hb, Wb, Cin, Cmid, Cout, dtype, seed=800 + i)[:7]
        cases[f"K4 pair of block {(1, 2, 3, 12)[i]}"] = (
            "K4", lambda ops=ops, lead=lead: ep.entry_pair(*ops, leading_relu0=lead))
    with chip_smoke.NoTF32(torch):
        ref1 = mb.middle_block_ref(*k1)
        for taps in ("fp32", "bf16"):
            got = through(mb, libs[("this", "K1")], lambda: mb.middle_block(*k1, taps=taps))()
            ref = mb.middle_block_ref(*k1, taps=taps) if taps == "bf16" else ref1
            print(f"[chip_variants] K1 {taps} taps at ({N},{H},{H},{C}): bit-equal share to the "
                  f"plain version {(got == ref).float().mean().item():.6f}", flush=True)
    for label, (k, fn) in cases.items():
        a = through(modules[k], libs[("older", k)], fn)
        t = through(modules[k], libs[("this", k)], fn)
        same = torch.equal(a(), t())
        ms = in_turns(torch, {"older": a, "this": t}, 10)
        print(f"[chip_variants] {label}: older {ms['older']:.4f} ms, this {ms['this']:.4f} ms, "
              f"outputs identical: {same}", flush=True)
        if k in ("K2", "K5"):  # the two halves of each build
            for tag, fn in (("older", a), ("this", t)):
                print(f"[chip_variants] {label} {tag}, device us per launch: " + "; ".join(
                    f"{key[:60]} {us:.2f} (x{n})" for key, (us, n) in device_us(torch, fn).items()),
                    flush=True)


def main(argv) -> int:
    import torch

    from multimodal_deepfake_detection_tpu_torch.ops.kernels._build import CSRC_DIR

    older = None
    if "--against" in argv:
        i = argv.index("--against")
        older = Path(argv[i + 1]).resolve()
        argv = argv[:i] + argv[i + 2:]
        if (older / "multimodal_deepfake_detection_tpu_torch" / "csrc").is_dir():
            older = older / "multimodal_deepfake_detection_tpu_torch" / "csrc"
    sections = argv or (["k4", "k1"] if older is None else [])
    if set(sections) - {"k4", "k1"}:
        raise SystemExit(f"unknown section(s): {sections}; known: k4, k1")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: chip_variants.py needs an NVIDIA GPU")
    with tempfile.TemporaryDirectory(prefix="kernel_variants_") as work:
        if "k4" in sections:
            section_k4(torch, Path(work), CSRC_DIR)
        if "k1" in sections:
            section_k1(torch, Path(work), CSRC_DIR)
        if older is not None:
            section_against(torch, Path(work), CSRC_DIR, older)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
