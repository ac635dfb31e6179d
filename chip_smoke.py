#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, each printing its lines; any failure raises and exits non-zero:

1. device: CUDA present; the card's name and power limit from nvidia-smi;
2. build: compile every kernel of the serving path from csrc/ with nvcc;
3. kernels: K1 (csrc/middle_block.cu) against its plain PyTorch version at
   the shapes serving gives it, TF32 off;
4. slice: a seeded full-width XceptionLSTMV + ArcFace bundle in the JAX
   format, a few uint8 clips at 256^2, scored through the port's CLI
   (``cli/serve.py --engine visual``, bf16 on CUDA); the launch counter must
   show 8 K1 launches per backbone call, and the scores and per-frame
   features must agree with the plain fp32 path;
5. times on the card (CUDA events after warmup): K1 against its plain
   version, and the slice's frames/s.

The line before the last is the card's ``name, power.limit``; the last line
is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

BF16_TOL = 1.6e-2  # two bf16 ulps at unit scale
MEAN_TOL = 1e-3
FEATURE_COS_MIN = 0.999
SCORE_TOL = 2e-2
K1_SHAPES = (  # (N, H=W, C, dtype name, row length of the packed pointwise weight)
    (256, 16, 728, "bfloat16", 736),
    (15, 4, 728, "bfloat16", 736),
    (15, 4, 728, "bfloat16", 728),
    (3, 2, 728, "bfloat16", 736),
    (1, 1, 728, "bfloat16", 736),
    (15, 4, 728, "float32", 736),
    (4, 8, 40, "bfloat16", 64),
)
CLIP_LENGTHS = (8, 5, 3, 8, 5)  # odd count, odd lengths; batch_size 4 -> 2 backbone calls
BATCH_SIZE = 4


def say(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def phase_device(torch):
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: chip_smoke.py needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}; nvidia-smi: {smi}")
    return smi


def phase_build():
    from multimodal_deepfake_detection_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    _build.load_library("middle_block")
    say(f"build: middle_block.cu ready in {time.perf_counter() - t0:.2f} s "
        f"({_build.BUILD_DIR.name}/, nvcc {' '.join(_build.NVCC_FLAGS[:2])})")


def k1_operands(torch, N, H, C, dtype, ldk, seed):
    """Random K1 operands; the pointwise rows' padding past C holds NaN, which
    the kernel must never read."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((N, H, H, C), generator=g).to("cuda", getattr(torch, dtype))
    dw = (torch.randn((3, 9, C), generator=g) * 0.2).cuda()
    pw = torch.full((3, C, ldk), float("nan"))
    pw[..., :C] = torch.randn((3, C, C), generator=g) / C ** 0.5
    b = (torch.randn((3, C), generator=g) * 0.1).cuda()
    return x, dw, pw.to("cuda", torch.bfloat16), b


def phase_kernels(torch) -> float:
    from multimodal_deepfake_detection_tpu_torch.ops.kernels.middle_block import (
        middle_block,
        middle_block_ref,
    )

    worst = 0.0
    for i, (N, H, C, dtype, ldk) in enumerate(K1_SHAPES):
        x, dw, pw, b = k1_operands(torch, N, H, C, dtype, ldk, seed=i)
        got = middle_block(x, dw, pw, b).float()
        torch.cuda.synchronize()
        ref = middle_block_ref(x, dw, pw, b).float()
        d = (got - ref).abs()
        max_d, mean_d = d.max().item(), d.mean().item()
        bound_ok = bool((d <= BF16_TOL + BF16_TOL * ref.abs()).all().item())
        say(f"K1 ({N},{H},{H},{C}) {dtype} ldk={ldk}: max|d|={max_d:.3e} mean|d|={mean_d:.3e} "
            f"bit-equal={(got == ref).float().mean().item():.4f}")
        if not (bound_ok and mean_d <= MEAN_TOL and torch.isfinite(got).all()):
            raise AssertionError(f"K1 disagrees with its plain version at ({N},{H},{H},{C}) {dtype}")
        worst = max(worst, max_d)
    return worst


def write_bundle(torch, path: str, hidden_dim: int = 128, seed: int = 0) -> None:
    """Seeded full-width XceptionLSTMV + ArcFace, random BN statistics, JAX format."""
    from multimodal_deepfake_detection_tpu_torch.core.checkpoint import save_bundle
    from multimodal_deepfake_detection_tpu_torch.models.heads import ArcFace, XceptionLSTM
    from multimodal_deepfake_detection_tpu_torch.ops.conv import BatchNorm
    from multimodal_deepfake_detection_tpu_torch.utils.jax_weights import (
        arcface_to_jax,
        xception_lstm_to_jax,
    )

    g = torch.Generator().manual_seed(seed)
    model = XceptionLSTM(hidden_dim, generator=g)
    with torch.no_grad():
        for bn in (m for m in model.modules() if isinstance(m, BatchNorm)):
            n = bn.mean.shape[0]
            bn.scale.copy_(0.8 + 0.4 * torch.rand(n, generator=g))
            bn.bias.copy_(0.05 * torch.randn(n, generator=g))
            bn.mean.copy_(0.1 * torch.randn(n, generator=g))
            bn.var.copy_(0.5 + torch.rand(n, generator=g))
    params, state = xception_lstm_to_jax(model)
    arc = arcface_to_jax(ArcFace(hidden_dim, 2, generator=g))
    save_bundle(path, {"model": params, "arcface": arc, "state": state})


def phase_slice(torch, workdir: str) -> int:
    from multimodal_deepfake_detection_tpu_torch.cli import serve as cli_serve
    from multimodal_deepfake_detection_tpu_torch.models.serve import VisualScorer
    from multimodal_deepfake_detection_tpu_torch.ops.kernels.middle_block import middle_block

    bundle = os.path.join(workdir, "visual.npz")
    write_bundle(torch, bundle)
    clip_dir = os.path.join(workdir, "clips")
    os.makedirs(clip_dir)
    rng = np.random.default_rng(0)
    clips = []
    for i, t in enumerate(CLIP_LENGTHS):
        clip = rng.integers(0, 256, (t, 256, 256, 3), dtype=np.uint8)
        np.save(os.path.join(clip_dir, f"clip{i}.npy"), clip)
        clips.append(clip)
    out = os.path.join(workdir, "scores.jsonl")

    middle_block.launches = 0
    emitted = cli_serve.main(
        ["--engine", "visual", "--ckpt_path", bundle, "--input", clip_dir, "--output", out,
         "--batch_size", str(BATCH_SIZE), "--compute_dtype", "bfloat16", "--device", "cuda"],
        log=say,
    )
    torch.cuda.synchronize()
    launches = middle_block.launches

    backbone_calls = -(-len(clips) // BATCH_SIZE)
    say(f"slice: {emitted} clips scored; K1 launches {launches} "
        f"(expected 8 x {backbone_calls} backbone calls)")
    if launches != 8 * backbone_calls:
        raise AssertionError(f"K1 launched {launches} times, expected {8 * backbone_calls}")
    recs = [json.loads(line) for line in open(out)]
    scores = np.array([r["score"] for r in recs], np.float64)
    if len(recs) != len(clips) or not (np.isfinite(scores).all() and (0 <= scores).all()
                                       and (scores <= 1).all()):
        raise AssertionError(f"bad JSONL output: {recs}")

    # reference: the plain path (no kernel) in fp32
    from multimodal_deepfake_detection_tpu_torch.cli.serve import _pad_stack

    kern = VisualScorer.from_bundle(bundle, device="cuda", buckets=(25, 50, 75))
    ref = VisualScorer.from_bundle(bundle, device="cuda", buckets=(25, 50, 75),
                                   compute_dtype=torch.float32, use_kernels=False)
    ref_scores, cos_min = [], 1.0
    for i in range(0, len(clips), BATCH_SIZE):
        batch, lengths = _pad_stack(clips[i : i + BATCH_SIZE])
        ref_scores.append(ref.score(batch, lengths))
        fk = kern.frame_features(batch).float()
        fr = ref.frame_features(batch).float()
        for j, n in enumerate(lengths):
            cos = torch.nn.functional.cosine_similarity(fk[j, :n], fr[j, :n], dim=-1)
            cos_min = min(cos_min, cos.min().item())
    ref_scores = np.concatenate(ref_scores)
    score_d = float(np.abs(scores - ref_scores).max())
    say(f"slice vs plain fp32: per-frame feature cos min {cos_min:.6f} "
        f"(>= {FEATURE_COS_MIN}), score max|d| {score_d:.3e} (<= {SCORE_TOL}); "
        f"scores {np.round(scores, 4).tolist()}")
    if cos_min < FEATURE_COS_MIN or score_d > SCORE_TOL:
        raise AssertionError("the slice disagrees with the plain fp32 path")
    return launches


def cuda_ms(torch, fn, iters: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_times(torch, smi: str, workdir: str):
    from multimodal_deepfake_detection_tpu_torch.models.serve import VisualScorer
    from multimodal_deepfake_detection_tpu_torch.ops.kernels.middle_block import (
        middle_block,
        middle_block_ref,
    )

    N, H, C = 256, 16, 728  # the middle trunk of 256 frames at 256^2
    x, dw, pw, b = k1_operands(torch, N, H, C, "bfloat16", 736, seed=99)
    kernel = lambda: middle_block(x, dw, pw, b)
    plain = lambda: middle_block_ref(x, dw, pw, b)
    for fn in (kernel, plain):
        fn()
    torch.cuda.synchronize()
    runs = {"plain": [], "kernel": []}
    for name in ("plain", "kernel", "kernel", "plain"):  # in turns
        runs[name].append(cuda_ms(torch, kernel if name == "kernel" else plain, 10))
    k_ms, p_ms = float(np.mean(runs["kernel"])), float(np.mean(runs["plain"]))
    flop = 3 * 2 * N * H * H * C * C
    say(f"time K1 ({N},{H},{H},{C}) bf16: kernel {k_ms:.4f} ms ({flop / k_ms / 1e9:.1f} TFLOP/s "
        f"on the pointwise), plain {p_ms:.4f} ms; runs {runs} [{smi}]")

    B, T, S = 32, 8, 256
    frames = np.random.default_rng(1).integers(0, 256, (B, T, S, S, 3), dtype=np.uint8)
    bundle = os.path.join(workdir, "visual.npz")
    scorers = {name: VisualScorer.from_bundle(bundle, device="cuda", use_kernels=name == "kernel")
               for name in ("kernel", "plain")}
    for sc in scorers.values():
        sc.score(frames)
    call_ms = {"plain": [], "kernel": []}
    for name in ("plain", "kernel", "kernel", "plain"):  # in turns
        t0 = time.perf_counter()
        for _ in range(5):
            scorers[name].score(frames)  # returns host scores: synchronised
        call_ms[name].append((time.perf_counter() - t0) / 5 * 1e3)
    rates = {}
    for name, runs in call_ms.items():
        ms = float(np.mean(runs))
        rates[name] = B * T / ms * 1e3
        say(f"time slice B={B} T={T} {S}^2 bf16 {name} middle flow: {ms:.2f} ms/call, "
            f"{rates[name]:.1f} frames/s; runs {runs} [{smi}]")
    return k_ms, p_ms, rates


def main() -> int:
    import torch

    import multimodal_deepfake_detection_tpu_torch  # noqa: F401  (fails outside a checkout)

    smi = phase_device(torch)
    phase_build()
    max_err = phase_kernels(torch)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        launches = phase_slice(torch, workdir)
        k_ms, p_ms, _ = phase_times(torch, smi, workdir)
    print(json.dumps({"kernels": [{
        "name": "middle_block",
        "route": "cuda",
        "source": "multimodal_deepfake_detection_tpu_torch/csrc/middle_block.cu",
        "replaces": "multimodal_deepfake_detection_tpu/ops/pallas/sepconv_pos.py:80",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
