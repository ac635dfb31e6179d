"""Multi-device dry run: one DP x TP train step, the checkpoint round trip,
and sharded AV scoring.

Counterpart of the repo root's ``__graft_entry__.py`` (``entry`` and
``dryrun_multichip``), without its fallback: the device is the caller's.

    python -m multimodal_deepfake_detection_tpu_torch.parallel.dryrun N --device cuda|cpu

launches N ranks (one process each; NCCL on ``cuda``, which needs N visible
GPUs, gloo on ``cpu``) that run, on a ``(data, model)`` mesh with model 2
when N >= 4 and even:

* the flagship (XceptionLSTMV + ArcFace, ``hidden_dim=16``) with its
  parameters placed by ``parallel/sharding.py``, one train step at B =
  2 x data, T = 2, 32^2 (live BN, ArcFace s 30 / m 0.5, the weighted CE,
  Adam with clip 1.0, the EMA; the backbone frozen, as in JAX);
* that step held to the same step in one process on the whole batch, from
  the same seed, at ``tests/test_multichip.py``'s bars: the loss within rel
  1e-5, the whole (all-gathered) parameters within rel 1e-6, the clipped
  gradients the optimizer used within rtol 1e-3 a leaf (a leaf negligible
  in the one-process step, under 1e-3 of the largest, must stay under
  2e-3), the BN running statistics within rel 1e-4; and, as a control, the
  same gradients with the ``model``-sharded leaves doubled (every leaf
  when nothing is sharded) must miss the gradient bar (Adam's first update
  does not see such a scale);
* a checkpoint (``core/orbax_ckpt.py``) of that state, restored into a
  fresh state of the same placements, then one more step from both,
  asserting bit-equal losses and parameters;
* with N >= 4 and even, the ``(dcn, data)`` mesh of ``hybrid_mesh(dcn_data=2)``;
* on rank 0, the ``AVScorer`` sharded over N devices of the type (a
  device named N times on the CPU) against the unsharded one, fp32, rtol
  1e-5 / atol 1e-6.

Any failed check or collective fails the run. ``entry()`` is the flagship's
bf16 forward on ``(2, 3, 64, 64, 3)``.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HIDDEN = 16


def _check(ok: bool, what: str) -> None:
    """A dry-run check (kept under ``python -O``, unlike ``assert``)."""
    if not ok:
        raise AssertionError(f"dryrun_multichip: {what}")


def build_flagship(seed: int = 0, hidden_dim: int = HIDDEN):
    """The flagship tree ``{backbone, lstm, fc_layers, fc_out, arcface}``
    from a seeded generator."""
    from ..models.heads import XceptionLSTMArcFace

    return XceptionLSTMArcFace(hidden_dim, generator=torch.Generator().manual_seed(seed))


def entry(device: str = "cuda"):
    """``(forward, args)``: the flagship's bf16 forward (video -> fake
    probability) and an example batch on ``device``."""
    from ..models.heads import arcface_apply, xception_lstm_embed, xception_lstm_features

    model = build_flagship().to(device)

    @torch.no_grad()
    def forward(model, video):
        feats, _ = xception_lstm_features(model, video, mode="video",
                                          compute_dtype=torch.bfloat16)
        emb = xception_lstm_embed(model, feats, compute_dtype=torch.bfloat16)
        return torch.softmax(arcface_apply(model.arcface.w, emb), dim=-1)[:, 1]

    return forward, (model, torch.zeros((2, 3, 64, 64, 3), device=device))


def _train_forward(model, rng_seed, batch):
    from ..models.heads import arcface_apply, xception_lstm_embed, xception_lstm_features
    from ..models.losses import cross_entropy_loss
    from .sharding import gathered

    video, labels, lengths = batch
    with gathered(model):
        feats, bn_stats = xception_lstm_features(model, video, mode="video", train=True)
        emb = xception_lstm_embed(model, feats, lengths=lengths)
        logits = arcface_apply(model.arcface.w, emb, labels.long(), s=30.0, m=0.5)
    loss = cross_entropy_loss(logits, labels.long(), sample_weight=(lengths > 0).float())
    return loss, (bn_stats, torch.softmax(logits, dim=-1)[:, 1])


def _placed_state(mesh, device):
    """The flagship's train state, its parameters placed on ``mesh`` (plain
    tensors when None)."""
    from ..train import TrainState, ema_init, make_optimizer
    from .sharding import place_params

    model = build_flagship().to(device)
    if mesh is not None:
        model = place_params(mesh, model)
    opt = make_optimizer(model.parameters(), "adam", 1e-4, grad_clip=1.0)
    return TrainState(0, model, opt, ema_init(model))


def _whole(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` read under ``like``'s placements (its local part is this rank's
    shard, as the optimizer updates it) and all-gathered, on the CPU; a
    plain tensor as it is."""
    from torch.distributed.tensor import DTensor

    if not isinstance(like, DTensor):
        return t.detach().cpu()
    _check(tuple(t.placements) == tuple(like.placements),
           f"gradient placements {t.placements} != the parameter's {like.placements}")
    local = t.detach().to_local()
    return DTensor.from_local(local, like.device_mesh, like.placements).full_tensor().cpu()


def _step_trees(model) -> dict:
    """``{"param", "grad", "bn"}``: name -> the whole tensor on the CPU (a
    collective over the mesh for sharded ones)."""
    params = dict(model.named_parameters())
    return {"param": {n: _whole(p, p) for n, p in params.items()},
            "grad": {n: _whole(p.grad, p) for n, p in params.items()},
            "bn": {n: b.detach().cpu() for n, b in model.named_buffers()}}


def _rel_norm(ref: dict, got: dict) -> float:
    sq_ref = sum(float(torch.linalg.vector_norm(v.double())) ** 2 for v in ref.values())
    sq_dif = sum(float(torch.linalg.vector_norm((got[k] - v).double())) ** 2
                 for k, v in ref.items())
    return (sq_dif ** 0.5) / (sq_ref ** 0.5 + 1e-30)


def _grad_rel(ref: dict, got: dict) -> float:
    """The largest per-leaf rel norm difference of the gradients, or inf when
    a leaf negligible in ``ref`` is not in ``got`` (``tests/test_multichip.py``'s
    rule)."""
    norm = lambda t: float(torch.linalg.vector_norm(t.double()))  # noqa: E731
    gmax = max(norm(v) for v in ref.values())
    worst = 0.0
    for k, a in ref.items():
        if norm(a) < 1e-3 * gmax:
            if norm(got[k]) >= 2e-3 * gmax:
                return float("inf")
        else:
            worst = max(worst, norm(got[k] - a) / norm(a))
    return worst


def _single_process_check(dp: dict, dp_loss: float, batch, sharded: set, device, log) -> dict:
    """The dry run's step in one process on the whole ``batch`` against the
    data x model step's trees ``dp``; raises when a bar is missed or the
    planted control (the ``sharded`` leaves' gradients doubled, or all of
    them when none is sharded) is not."""
    from ..train.steps import make_train_step

    state = _placed_state(None, device)
    step = make_train_step(_train_forward, use_ema=True)
    state, loss, _ = step(state, tuple(torch.from_numpy(a).to(device) for a in batch), 0,
                          ("backbone",))
    ref = _step_trees(state.model)
    got = {"loss": abs(dp_loss - float(loss)) / abs(float(loss)),
           "param": _rel_norm(ref["param"], dp["param"]),
           "grad": _grad_rel(ref["grad"], dp["grad"]),
           "bn": _rel_norm(ref["bn"], dp["bn"])}
    bars = {"loss": 1e-5, "param": 1e-6, "grad": 1e-3, "bn": 1e-4}
    for k, bar in bars.items():
        _check(got[k] < bar, f"data x model step vs one process: {k} rel {got[k]:.3e} >= {bar}")
    doubled = sharded or set(dp["grad"])
    planted = {k: 2 * g if k in doubled else g for k, g in dp["grad"].items()}
    got["planted_grad"] = _grad_rel(ref["grad"], planted)
    _check(got["planted_grad"] >= bars["grad"],
           f"the planted control (gradients x2) passed: rel {got['planted_grad']}")
    log("dryrun_multichip single-process OK: loss rel {loss:.2e}, params rel {param:.2e}, "
        "grads rel {grad:.2e}, BN rel {bn:.2e}; planted x2 on {what}: "
        "rel {planted_grad:.2e}".format(what="the model-sharded grads" if sharded else "all grads",
                                        **got))
    return got


def _locals(model) -> list:
    from .distributed import local_tensor

    return [local_tensor(p.detach()).cpu() for p in model.parameters()]


def _av_check(n: int, device: torch.device, log) -> float:
    """The sharded AVScorer over ``n`` devices against the unsharded one."""
    from ..models.heads import XceptionLSTM
    from ..models.serve import AudioScorer, AVScorer, VisualScorer
    from .mesh import local_devices

    visual = build_flagship()
    audio = XceptionLSTM(HIDDEN, generator=torch.Generator().manual_seed(1))
    mesh = local_devices(device.type)[:n] if device.type == "cuda" else [device] * n
    rng = np.random.default_rng(1)
    frames = (rng.random((n, 2, 32, 32, 3)) * 255).astype(np.uint8)
    waves = rng.normal(0, 0.1, (n, 4096)).astype(np.float32)

    def build(mesh):
        kw = dict(compute_dtype=torch.float32, device=device, mesh=mesh)
        return AVScorer(VisualScorer(visual, visual.arcface, **kw), AudioScorer(audio, **kw))

    sharded, single = build(mesh).score(frames, waves), build(None).score(frames, waves)
    _check(sharded.shape == (n,) and bool(np.all(np.isfinite(sharded))), f"AV scores {sharded}")
    np.testing.assert_allclose(sharded, single, rtol=1e-5, atol=1e-6)
    err = float(np.max(np.abs(sharded - single)))
    log(f"dryrun_multichip AV eval OK: AVScorer sharded over {len(mesh)} devices, fused "
        f"scores match single-device (max|d|={err:.2e})")
    return err


def run_rank(rank: int, n: int, port: int, device: str, ckdir: str) -> dict:
    """One rank of the dry run (joining the process group, unless one is up
    already, and then ending it); returns its results (rank 0's log
    lines)."""
    import torch.distributed as dist

    from ..core.orbax_ckpt import OrbaxStateManager
    from ..train.steps import make_train_step
    from .distributed import hybrid_mesh, initialize
    from .mesh import data_sharding, make_mesh
    from .sharding import param_placements

    lines = []
    log = lines.append if rank == 0 else (lambda s: None)
    owned = not dist.is_initialized()
    own = initialize(f"127.0.0.1:{port}", n, rank, device=device)
    model_size = 2 if n % 2 == 0 and n >= 4 else 1
    data_size = n // model_size
    mesh = make_mesh(("data", "model"), (data_size, model_size), device_type=own.type)
    res = {"rank": rank, "mesh": [data_size, model_size]}

    B, T, S = 2 * data_size, 2, 32
    rng = np.random.default_rng(0)
    video = rng.random((B, T, S, S, 3), np.float32)
    labels = (np.arange(B) % 2).astype(np.float32)
    lengths = np.full((B,), T, np.int64)
    rows = data_sharding(data_size, B)[mesh.get_local_rank("data")]
    batch = tuple(torch.from_numpy(a[rows]).to(own) for a in (video, labels, lengths))

    step = make_train_step(_train_forward, use_ema=True, data_group=mesh.get_group("data"))
    state = _placed_state(mesh, own)
    state, loss, probs = step(state, batch, 0, ("backbone",))
    loss = float(loss)
    _check(bool(np.isfinite(loss)), f"non-finite loss {loss}")
    _check(state.step == 1 and tuple(probs.shape) == (B,), f"step {state.step}, {probs.shape}")
    log(f"dryrun_multichip OK: mesh=({data_size}x{model_size}) devices={n} loss={loss:.4f} "
        f"step={state.step}")
    res["loss"] = loss
    trees = _step_trees(state.model)
    if rank == 0:
        sharded = {k for k, pl in param_placements(state.model, model_size).items()
                   if pl.is_shard()}
        res["vs_single"] = _single_process_check(trees, loss, (video, labels, lengths), sharded,
                                                 own, log)

    mgr = OrbaxStateManager(ckdir)
    mgr.save(1, state)
    restored = mgr.restore_latest(like=_placed_state(mesh, own))
    _check(restored.step == 1, f"restored step {restored.step}")
    restored, loss_resumed, _ = step(restored, batch, 1, ("backbone",))
    state, loss_cont, _ = step(state, batch, 1, ("backbone",))
    _check(float(loss_resumed) == float(loss_cont),
           f"resumed loss {float(loss_resumed)} != {float(loss_cont)}")
    _check(all(torch.equal(a, b) for a, b in zip(_locals(restored.model), _locals(state.model))),
           "resumed parameters differ from the uninterrupted run's")
    log("dryrun_multichip checkpoint OK: sharded save/restore/step matches uninterrupted "
        f"run (loss={float(loss_cont):.4f})")

    if n >= 4 and n % 2 == 0:
        hm = hybrid_mesh(dcn_data=2)
        _check(tuple(hm.shape) == (2, n // 2) and hm.mesh_dim_names == ("dcn", "data"), str(hm))
        log(f"dryrun_multichip hybrid mesh OK: (dcn, data) = {tuple(hm.shape)}")
    if rank == 0:
        res["av_max_abs_err"] = _av_check(n, own, log)
    dist.barrier()
    if owned:
        dist.destroy_process_group()
    res["lines"] = lines
    return res


def spawn_ranks(n: int, argv, *, feed=None, timeout: float = 900) -> list:
    """Run ``argv(rank)`` (a command line) for ranks ``0 .. n-1`` at once,
    with the repo on ``PYTHONPATH``, and wait for them; each rank prints its
    results as a last ``RESULT <json>`` line. ``feed()``, when given, is
    called once the ranks have started and its bytes go to every rank's
    standard input. Returns the results in rank order; raises when a rank
    fails, and kills the ranks left when one hangs."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    pipe = subprocess.PIPE
    procs = [subprocess.Popen(argv(r), stdin=pipe if feed else subprocess.DEVNULL, stdout=pipe,
                              stderr=pipe, env=env) for r in range(n)]
    try:
        data = feed() if feed is not None else None
        with ThreadPoolExecutor(n) as pool:  # every rank's input at once: they meet in collectives
            outs = list(pool.map(lambda p: p.communicate(data, timeout=timeout), procs))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    results = []
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        out, err = out.decode(errors="replace"), err.decode(errors="replace")
        found = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        if p.returncode != 0 or not found:
            raise RuntimeError(f"rank {r} failed (rc {p.returncode}):\n{out[-2000:]}\n"
                               f"{err[-4000:]}")
        results.append(json.loads(found[-1][len("RESULT "):]))
    return results


def check_ranks(results: list) -> dict:
    """The ranks' dry-run results agree on the loss; rank 0's."""
    _check(len({res["loss"] for res in results}) == 1,
           f"ranks disagree on the loss: {[res['loss'] for res in results]}")
    return results[0]


def dryrun_multichip(n_devices: int, *, device: str = "cuda") -> dict:
    """Launch ``n_devices`` ranks of the dry run and wait for them; raises
    when one fails (or, on ``cuda``, when fewer GPUs are visible). Returns
    rank 0's results."""
    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < n_devices:
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            raise RuntimeError(f"dryrun_multichip({n_devices}, device='cuda'): "
                               f"{have} GPU(s) visible")
    elif device != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    from .distributed import free_port

    ckdir, port = tempfile.mkdtemp(prefix="dryrun_dcp_"), free_port()
    try:
        return check_ranks(spawn_ranks(n_devices, lambda r: [
            sys.executable, "-m", "multimodal_deepfake_detection_tpu_torch.parallel.dryrun",
            str(n_devices), "--device", device, "--rank", str(r), "--port", str(port),
            "--ckdir", ckdir]))
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="dryrun")
    ap.add_argument("n", type=int)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--ckdir", default=None)
    args = ap.parse_args(argv)
    if args.rank is None:
        fn, ex = entry(args.device)
        print("entry forward:", fn(*ex).float().cpu().numpy())
        for line in dryrun_multichip(args.n, device=args.device)["lines"]:
            print(line)
        return
    torch.set_num_threads(1)
    res = run_rank(args.rank, args.n, args.port, args.device, args.ckdir)
    print("RESULT " + json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
