"""The port's AU-face trainer against the JAX package's.

* Five calls of ``cli/train_au_face``'s train step (its own optimizer on
  both sides: AdamW on the OneCycle schedule, the clip, 4 micro-batches a
  step; the EMA) against the JAX CLI's own forward, captured from its
  ``build()`` (the initial weights the port's, exported), under JAX's
  ``make_train_step``, fp64 with dropout off (``tests/train_oracle.py``):
  every call's loss rtol 1e-12; the averaged gradient after 3 accumulating
  calls, each tensor scaled by the larger of its largest in either package
  and 1e-6 of the largest overall, atol 1e-9; after the 4th call (the real
  step) the running statistics rtol 1e-10 / atol 1e-12 and the post-step
  parameters and EMA on the same scale within 1e-6: Adam's first step
  divides each gradient element by its own size plus eps 1e-8, so an
  element's gradient roundoff grows by eps / |g| there (5.27e-8 read; the
  gradients themselves hold 1e-9).
* The eval step against the JAX CLI's ``raw_eval`` on the same state, the
  EMA moved away from the current weights: loss and probabilities within
  1e-10; it reads the current ArcFace head (a change to the EMA's leaves
  the result, a change to the current one moves it).
* ``train_au_face`` on the CPU, fp32, 2 epochs on a synthetic tree (tokens
  of 8, images of 16^2): its bundle loads strictly into both packages'
  ``AUFaceScorer.from_bundle`` and both score the same inputs within 1e-4;
  it logs the Youden and FPR <= 5 % points; the flags that wait for another
  item raise and name it; ``--device cuda`` raises without CUDA.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_deepfake_detection_tpu.cli import train_au_face as jface_cli
from multimodal_deepfake_detection_tpu.core.checkpoint import load_bundle, merge_params
from multimodal_deepfake_detection_tpu.models import au_face as jau
from multimodal_deepfake_detection_tpu.models import losses as jlosses
from multimodal_deepfake_detection_tpu.models import serve as jserve
from multimodal_deepfake_detection_tpu.train.steps import make_train_step as jax_make_train_step
from multimodal_deepfake_detection_tpu_torch.cli import train_au_face as tface_cli
from multimodal_deepfake_detection_tpu_torch.data.synthetic import make_joint_tree
from multimodal_deepfake_detection_tpu_torch.models.serve import AUFaceScorer
from multimodal_deepfake_detection_tpu_torch.train import ema_init
from multimodal_deepfake_detection_tpu_torch.train.steps import (
    SwappedParams,
    make_eval_step,
    make_train_step,
)
from multimodal_deepfake_detection_tpu_torch.utils import jax_weights

from au_trees import FACE_LSTM, face_tree
from train_oracle import (
    STEP_BARS,
    assert_scaled,
    assert_stats,
    capture_jax_build,
    no_dropout,
    np_copy,
    randomize_buffers,
)
from test_torch_train_au import SIZE, _torch_batch
from test_torch_train_step import _flatten, enable_x64, one_torch_thread  # noqa: F401

ADAM_STEP_DELTAS = 1e-6  # the post-step deltas of Adam's first step (see the docstring)


@pytest.fixture(scope="module")
def joint_roots(tmp_path_factory):
    root = tmp_path_factory.mktemp("joint_tree")
    video, au = make_joint_tree(str(root / "v"), str(root / "a"), n_per_class=2, frames=2,
                                n_aus=2, face_size=SIZE, patch_size=SIZE, seed=6)
    for d, names in ((video, ["fake_1.npy"]), (au, ["fake_1.npy", "fake_1_weights.npy"])):
        for name in names:  # 2 real and 1 fake in train: class weights not 1
            os.remove(os.path.join(d, "train", name))
    return video, au


FACE_CFG = dict(num_aus=2, face_dim=2 * FACE_LSTM, au_dim=2 * FACE_LSTM, lstm_hidden=FACE_LSTM,
                embed_dim=8, image_size=SIZE, max_frames=2, epochs=3, compute_dtype="float32",
                device="cpu")


def _face_batch(seed):
    rng = np.random.default_rng(seed)
    mask = np.ones((2, 2, 2), np.float32)
    mask[1, 1] = 0  # the second clip's last frame has no AUs
    return ((rng.random((2, 2, SIZE, SIZE, 3)), rng.random((2, 2, 2, SIZE, SIZE, 3)), mask,
             rng.random((2, 2, 2)).astype(np.float32) * mask),
            np.array([1.0, 0.0]), np.array([2, 2], np.int32))


def _face_trees(model):
    """The port's train tree -> the JAX CLI's ``(params, bn_state)``."""
    det, det_state = jax_weights.au_face_to_jax(model.model)
    params = {"model": det, "embed": jax_weights.embed_head_to_jax(model.embed),
              "arcface": jax_weights.arcface_to_jax(model.arcface)}
    return np_copy((params, {"model": det_state}))


def _named_tree(model, tensors: dict):
    """Per-parameter tensors (by name) laid out as the JAX params tree."""
    with SwappedParams(model, tensors):
        return _face_trees(model)[0]


@pytest.fixture(scope="module")
def face_run(joint_roots):
    """Both au_face trainers from one state over 5 calls: -> the readings."""
    mp = pytest.MonkeyPatch()
    torch_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _face_run(joint_roots, mp)
    finally:
        mp.undo()
        torch.set_num_threads(torch_threads)


def _face_run(joint_roots, monkeypatch):
    video, au = joint_roots
    cfg = dict(FACE_CFG, video_root=video, au_root=au)
    _, _, _, state, _, _ = tface_cli.build(tface_cli.Config(**cfg))
    model = randomize_buffers(state.model.double(), 10)
    state.ema = ema_init(model)
    p0, s0 = _face_trees(model)
    calls = capture_jax_build(monkeypatch, jface_cli, {
        "au_face_detector_init": (p0["model"], s0["model"]),
        "embed_head_init": p0["embed"], "arcface_init": p0["arcface"]})
    with enable_x64():  # the oracle's fp64 class weights, of the train split's 2 real, 1 fake
        class_weights = torch.from_numpy(np.array(jlosses.cb_focal_class_weights([2, 1])))
    fwd, eval_forward = tface_cli.make_forwards(tface_cli.Config(**cfg), torch.float64,
                                                class_weights)

    def loss_forward(m, rng_seed, b):
        loss, stats, probs = fwd(m, b, None)
        return loss, (stats, probs)

    t_step = make_train_step(loss_forward, use_ema=True)
    batches = [_face_batch(20 + i) for i in range(5)]
    out = {"p0": p0, "s0": s0, "t_loss": [], "j_loss": []}
    jcfg = jface_cli.Config(**{k: v for k, v in cfg.items() if k != "device"})
    with enable_x64():
        _, _, _, jstate, _, raw_eval = jface_cli.build(jcfg)
        fwd_j, tx, kw = calls[0]
        assert kw == {"use_ema": True}
        j_step = jax_make_train_step(no_dropout(fwd_j), tx, use_ema=True)
        for i, batch in enumerate(batches):
            state, loss, _ = t_step(state, _torch_batch(batch), 0)
            jstate, j_loss, _ = j_step(jstate, jax.tree_util.tree_map(jnp.asarray, batch), 0, ())
            out["t_loss"].append(float(loss))
            out["j_loss"].append(float(j_loss))
            if i == 2:  # 3 micro-batches averaged, no step yet
                names = [n for n, _ in model.named_parameters()]
                out["t_acc"] = _named_tree(model, dict(zip(names, state.optimizer.acc)))
                out["j_acc"] = np_copy(jstate.opt_state.acc_grads)
            if i == 3:  # the real step
                out["t_params"], out["t_state"] = _face_trees(model)
                out["t_ema"] = _named_tree(model, state.ema.params)
                out["j_params"], out["j_state"] = np_copy(jstate.params), np_copy(
                    jstate.bn_state)
                out["j_ema"] = np_copy(jstate.ema.params)
        # eval with the EMA moved away from the current weights, both packages alike
        g = torch.Generator().manual_seed(11)
        for t in state.ema.params.values():
            t.add_(torch.randn(t.shape, generator=g, dtype=t.dtype) * 0.05)
        jstate = jstate._replace(ema=jstate.ema._replace(params=jax.tree_util.tree_map(
            jnp.asarray, _named_tree(model, state.ema.params))))
        eval_batch = _face_batch(30)
        j_eval = raw_eval(jstate, jax.tree_util.tree_map(jnp.asarray, eval_batch))
        out["j_eval"] = tuple(np.asarray(a) for a in j_eval)
    ev = make_eval_step(eval_forward, use_ema_params=True, keep_current=("arcface",))
    tb = _torch_batch(eval_batch)
    out["t_eval"] = tuple(a.numpy() for a in ev(state, tb))
    with torch.no_grad():  # the EMA's ArcFace leaves is not read; the current one is
        state.ema.params["arcface.w"].mul_(-1)
        out["t_eval_ema_arc"] = tuple(a.numpy() for a in ev(state, tb))
        model.arcface.w.mul_(-1)
        out["t_eval_cur_arc"] = tuple(a.numpy() for a in ev(state, tb))
        model.arcface.w.mul_(-1)
    return out


def test_au_face_accumulating_calls_match_jax_fp64(face_run):
    np.testing.assert_allclose(face_run["t_loss"], face_run["j_loss"], rtol=STEP_BARS["loss"])
    zero = jax.tree_util.tree_map(np.zeros_like, face_run["p0"])
    assert_scaled(_flatten(face_run["j_acc"]), _flatten(face_run["t_acc"]), _flatten(zero))


def test_au_face_step_and_ema_match_jax_fp64(face_run):
    p0 = _flatten(face_run["p0"])
    for key in ("params", "ema"):
        assert_scaled(_flatten(face_run["j_" + key]), _flatten(face_run["t_" + key]), p0,
                       atol=ADAM_STEP_DELTAS)
    assert_stats(_flatten(face_run["j_state"]), _flatten(face_run["t_state"]),
                  _flatten(face_run["s0"]))


def test_au_face_eval_step_matches_jax_fp64(face_run):
    for got, want in zip(face_run["t_eval"], face_run["j_eval"]):
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)
    for got, want in zip(face_run["t_eval_ema_arc"], face_run["t_eval"]):
        np.testing.assert_array_equal(got, want)
    assert not np.allclose(face_run["t_eval_cur_arc"][1], face_run["t_eval"][1])


# ---------------------------------------------------------------------------
# The CLIs
# ---------------------------------------------------------------------------

@pytest.fixture
def face_template(monkeypatch):
    """The JAX ``AUFaceScorer.from_bundle`` with ``tests/au_trees.py``'s cached
    tree as its template (of the same shapes; eager init of two ResNet-18s
    takes ~20 s on the CPU): the bundle's leaves replace all of it."""
    tree = face_tree()  # built (and cached) before the init it calls is patched
    monkeypatch.setattr(jau, "au_face_detector_init", lambda *a, **kw: tree)


def test_train_au_face_cli_bundle_serves_in_both_packages(joint_roots, tmp_path, face_template,
                                                          one_torch_thread):
    video, au = joint_roots
    logs = []
    argv = ["--video_root", video, "--au_root", au, "--checkpoint_dir", str(tmp_path),
            "--seed", "4"]
    for k, v in FACE_CFG.items():
        argv += [f"--{k}", str(v)]
    argv[argv.index("--epochs") + 1] = "2"
    history = tface_cli.main(argv, log=logs.append)
    assert len(history) == 2 and all(np.isfinite(r.train_loss) for r in history)
    assert any(line.startswith("Eval@Youden") for line in logs)
    assert any(line.startswith("Eval@FPR<=5%") for line in logs)
    path = str(tmp_path / tface_cli.Config.bundle_name)
    assert os.path.exists(path), logs
    bundle = load_bundle(path)
    assert set(bundle) == {"model", "embed", "arcface", "state", "best_auc"}
    t_params, t_state = face_tree()
    merge_params(t_params, bundle["model"], strict=True)
    merge_params(t_state, bundle["state"], strict=True)
    jsc = jserve.AUFaceScorer.from_bundle(path, num_aus=2, lstm_hidden=FACE_LSTM,
                                          compute_dtype=jnp.float32)
    tsc = AUFaceScorer.from_bundle(path, lstm_hidden=FACE_LSTM, compute_dtype=torch.float32,
                                   device="cpu")
    rng = np.random.default_rng(12)
    videos = rng.integers(0, 255, (2, 2, SIZE, SIZE, 3), np.uint8)
    patches = rng.integers(0, 255, (2, 2, 2, SIZE, SIZE, 3), np.uint8)
    np.testing.assert_allclose(tsc.score(videos, patches), jsc.score(videos, patches),
                               rtol=0, atol=1e-4)


def test_ckpt_backend_orbax_passes_the_flag_check():
    """``--ckpt_backend orbax`` is ported (``tests/test_torch_orbax_ckpt.py``
    trains with it); a backend the CLI has no path for raises."""
    parse = lambda argv: tface_cli.parse_config(tface_cli.Config, argv,  # noqa: E731
                                                prog="train_au_face")
    tface_cli.check_config(parse(["--ckpt_backend", "orbax"]))
    with pytest.raises(ValueError, match="ckpt_backend"):
        tface_cli.build(parse(["--ckpt_backend", "tar", "--device", "cpu"]))


def test_missing_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tface_cli.Config().device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tface_cli.build(tface_cli.Config())
