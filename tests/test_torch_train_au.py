"""The port's AU-patch trainer, ResNet-18 in training and the heads' dropout,
against the JAX package.

* ``ResNet18.train_forward`` against ``resnet18_apply(train=True)`` in
  fp64: the features rtol 1e-10, the new running statistics (applied once)
  rtol 1e-10 / atol 1e-12, every BN's.
* One SGD step of ``cli/train_au_patch``'s forward under its
  ``make_train_step`` against the JAX CLI's own forward, captured from its
  ``build()`` (the initial weights the port's, exported), under JAX's
  ``make_train_step``, fp64 (``tests/train_oracle.py``), unfrozen, B=2 x T=2
  x A=2 patches of 16^2, one clip padded. Bars, those of
  ``tests/test_torch_train_step.py``: the loss rtol 1e-12; each post-step
  delta, scaled by the larger of its tensor's largest delta in either
  package and 1e-6 of the largest overall, atol 1e-9; the running
  statistics rtol 1e-10 / atol 1e-12.
* The heads' dropout (keep 0.7 after each of the audio MLP's ReLUs, 0.8 in
  the embed head): the keep rate on 10^6 elements within 0.01, the kept
  values scaled by exactly 1 / keep, the identity in eval and without a
  generator, one seed one mask.
* ``train_au_patch`` on the CPU, fp32, 2 epochs on a synthetic tree
  (hidden 8, patches of 16^2; no dropout) from the same initial weights as
  the JAX CLI: the same per-epoch train and eval losses within rtol 1e-3,
  bundles of the same leaves; the flags that wait for another item raise
  and name it; ``--device cuda`` raises without CUDA.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_deepfake_detection_tpu.cli import train_au_patch as jpatch_cli
from multimodal_deepfake_detection_tpu.core.checkpoint import load_bundle
from multimodal_deepfake_detection_tpu.models.resnet import resnet18_apply
from multimodal_deepfake_detection_tpu.train import TrainState as JaxTrainState
from multimodal_deepfake_detection_tpu.train.steps import make_train_step as jax_make_train_step
from multimodal_deepfake_detection_tpu_torch.cli import train_au_patch as tpatch_cli
from multimodal_deepfake_detection_tpu_torch.data.synthetic import make_au_patch_tree
from multimodal_deepfake_detection_tpu_torch.models import heads as theads
from multimodal_deepfake_detection_tpu_torch.models.resnet_lstm import AUPatchClassifier
from multimodal_deepfake_detection_tpu_torch.models.xception import apply_bn_stats
from multimodal_deepfake_detection_tpu_torch.ops.conv import Linear
from multimodal_deepfake_detection_tpu_torch.ops.lstm import LSTM
from multimodal_deepfake_detection_tpu_torch.train import TrainState
from multimodal_deepfake_detection_tpu_torch.train.optim import Optimizer
from multimodal_deepfake_detection_tpu_torch.train.steps import make_train_step
from multimodal_deepfake_detection_tpu_torch.utils import jax_weights

from train_oracle import (
    STEP_BARS,
    assert_scaled,
    assert_stats,
    capture_jax_build,
    no_dropout,
    np_copy,
    randomize_buffers,
)
from test_torch_train_step import _flatten, enable_x64, one_torch_thread  # noqa: F401

LR = 0.05
SIZE = 16


# ---------------------------------------------------------------------------
# ResNet-18 in batch-statistics BN
# ---------------------------------------------------------------------------

def test_resnet18_train_forward_matches_jax_fp64():
    model = randomize_buffers(AUPatchClassifier(8, 4, generator=torch.Generator().manual_seed(1))
                              .double(), 2)
    params, state = np_copy(jax_weights.au_patch_to_jax(model))
    x = np.random.default_rng(3).random((6, 32, 32, 3))
    feats, stats = model.backbone.train_forward(torch.from_numpy(x))
    assert len(stats) == 1 + 2 * 8 + 3  # the stem, each block's two, three shortcuts
    apply_bn_stats(stats)
    _, t_state = jax_weights.au_patch_to_jax(model)
    with enable_x64():
        want, j_state = jax.jit(functools.partial(resnet18_apply, train=True))(
            jax.tree_util.tree_map(jnp.asarray, params["backbone"]),
            jax.tree_util.tree_map(jnp.asarray, state["backbone"]), jnp.asarray(x))
        want, j_state = np.asarray(want), np_copy(j_state)
    np.testing.assert_allclose(feats.detach().numpy(), want, rtol=1e-10, atol=0)
    assert_stats(_flatten(j_state), _flatten(t_state["backbone"]), _flatten(state["backbone"]))


# ---------------------------------------------------------------------------
# One step of each AU trainer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def patch_root(tmp_path_factory):
    return make_au_patch_tree(str(tmp_path_factory.mktemp("patch_tree")), n_per_class=2,
                              frames=2, n_aus=2, size=SIZE, seed=5)


def _patch_batch(seed):
    rng = np.random.default_rng(seed)
    return ((rng.random((2, 2, 2, SIZE, SIZE, 3)), rng.random((2, 2, 2)).astype(np.float32)),
            np.array([0.0, 1.0]), np.array([2, 1], np.int32))


def _torch_batch(batch, dtype=torch.float64):
    def put(a):
        if isinstance(a, tuple):
            return tuple(put(b) for b in a)
        t = torch.from_numpy(np.asarray(a))
        return t.to(dtype) if t.dtype == torch.float64 else t
    return put(batch)


def test_au_patch_step_matches_jax_fp64(patch_root, monkeypatch, one_torch_thread):
    cfg = dict(data_root=patch_root, hidden_dim=8, lstm_hidden=4, image_size=SIZE, max_frames=2,
               max_aus=2, compute_dtype="float32")
    model = randomize_buffers(AUPatchClassifier(8, 4, generator=torch.Generator().manual_seed(7))
                              .double(), 8)
    p0, s0 = np_copy(jax_weights.au_patch_to_jax(model))
    batch = _patch_batch(9)

    forward = tpatch_cli.make_forward(tpatch_cli.Config(**cfg), torch.float64)

    def loss_forward(m, rng_seed, b):
        loss, stats, probs = forward(m, b, True)
        return loss, (stats, probs)

    state = TrainState(0, model, Optimizer(torch.optim.SGD(model.parameters(), lr=LR)))
    _, t_loss, _ = make_train_step(loss_forward)(state, _torch_batch(batch), 0)
    t_params, t_state = jax_weights.au_patch_to_jax(model)

    calls = capture_jax_build(monkeypatch, jpatch_cli, {"au_patch_classifier_init": (p0, s0)})
    with enable_x64():
        jpatch_cli.build(jpatch_cli.Config(**cfg))
        fwd = calls[0][0]
        tx = optax.sgd(LR)
        p = jax.tree_util.tree_map(jnp.asarray, p0)
        jstate = JaxTrainState(jnp.zeros((), jnp.int32), p,
                               jax.tree_util.tree_map(jnp.asarray, s0), tx.init(p))
        new, j_loss, _ = jax_make_train_step(no_dropout(fwd), tx)(
            jstate, jax.tree_util.tree_map(jnp.asarray, batch), 0, ())
        j_params, j_state, j_loss = np_copy(new.params), np_copy(new.bn_state), float(j_loss)
    np.testing.assert_allclose(float(t_loss), j_loss, rtol=STEP_BARS["loss"])
    assert_scaled(_flatten(j_params), _flatten(t_params), _flatten(p0))
    assert_stats(_flatten(j_state), _flatten(t_state), _flatten(s0))


# ---------------------------------------------------------------------------
# Dropout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("keep", [0.7, 0.8])
def test_dropout_rate_scale_and_seed(keep):
    h = torch.rand(1000, 1000) + 0.5
    out = theads.dropout(h, keep, torch.Generator().manual_seed(0))
    kept = out != 0
    assert abs(kept.float().mean().item() - keep) < 0.01
    assert torch.equal(out[kept], h[kept] / keep)
    assert torch.equal(out, theads.dropout(h, keep, torch.Generator().manual_seed(0)))
    assert not torch.equal(out, theads.dropout(h, keep, torch.Generator().manual_seed(1)))
    assert theads.dropout(h, keep, None) is h


class _Head(torch.nn.Module):
    """The audio head's modules without the backbone."""

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.lstm = LSTM(16, 8, g)
        self.fc_layers = torch.nn.ModuleList(
            [Linear(8, theads.MLP_WIDTH, g)] + [Linear(theads.MLP_WIDTH, theads.MLP_WIDTH, g)
                                                for _ in range(3)])
        self.fc_out = Linear(theads.MLP_WIDTH, 1, g)


@pytest.mark.parametrize("head", ["audio", "embed"])
def test_heads_dropout(head, monkeypatch):
    x = torch.rand(4, 3, 16) if head == "audio" else torch.rand(4, 16)
    if head == "audio":
        module, keep, n = _Head(), 0.7, 4
        run = lambda **kw: theads.xception_lstm_head_apply(module, x, **kw)
    else:
        module = theads.EmbedHead(16, generator=torch.Generator().manual_seed(0))
        keep, n = 0.8, 1
        run = lambda **kw: theads.embed_head_apply(module, x, **kw)
    seen = []
    real = theads.dropout
    monkeypatch.setattr(theads, "dropout", lambda h, k, g: seen.append(k) or real(h, k, g))
    ref = run()
    assert seen == []  # eval: no dropout drawn
    assert torch.equal(run(train=True), ref)  # no generator: the identity
    assert torch.equal(run(train=False, generator=torch.Generator().manual_seed(1)), ref)
    a = run(train=True, generator=torch.Generator().manual_seed(1))
    assert seen[-n:] == [keep] * n
    assert torch.equal(a, run(train=True, generator=torch.Generator().manual_seed(1)))
    assert not torch.equal(a, ref)


# ---------------------------------------------------------------------------
# The CLIs
# ---------------------------------------------------------------------------

PATCH_ARGV = ["--hidden_dim", "8", "--lstm_hidden", "4", "--image_size", str(SIZE),
              "--max_frames", "2", "--max_aus", "2", "--epochs", "2", "--compute_dtype",
              "float32", "--seed", "3"]


def test_train_au_patch_cli_loss_history_matches_jax(patch_root, tmp_path, monkeypatch,
                                                     one_torch_thread):
    logs = []
    history = tpatch_cli.main(["--data_root", patch_root, "--checkpoint_dir",
                               str(tmp_path / "t"), "--device", "cpu"] + PATCH_ARGV,
                              log=logs.append)
    bundle = load_bundle(str(tmp_path / "t" / tpatch_cli.Config.bundle_name))
    # the JAX CLI from the port's initial weights
    init = AUPatchClassifier(8, 4, generator=torch.Generator().manual_seed(3))
    trees = np_copy(jax_weights.au_patch_to_jax(init))
    monkeypatch.setattr(jpatch_cli, "au_patch_classifier_init",
                        lambda *a, **kw: jax.tree_util.tree_map(jnp.asarray, trees))
    monkeypatch.setenv("MDD_NO_COMPILE_CACHE", "1")
    j_history = jpatch_cli.main(["--data_root", patch_root, "--checkpoint_dir",
                                 str(tmp_path / "j")] + PATCH_ARGV, log=lambda s: None)
    assert len(history) == len(j_history) == 2
    for got, want in zip(history, j_history):
        np.testing.assert_allclose([got.train_loss, got.eval_loss],
                                   [want.train_loss, want.eval_loss], rtol=1e-3)
    j_bundle = load_bundle(str(tmp_path / "j" / jpatch_cli.Config.bundle_name))
    assert sorted(_flatten(bundle)) == sorted(_flatten(j_bundle))
    assert os.path.exists(tmp_path / "t" / "train_au_patch_state.pt")


def test_ckpt_backend_orbax_passes_the_flag_check():
    """``--ckpt_backend orbax`` is ported (``tests/test_torch_orbax_ckpt.py``
    trains with it); a backend the CLI has no path for raises."""
    parse = lambda argv: tpatch_cli.parse_config(tpatch_cli.Config, argv,  # noqa: E731
                                                 prog="train_au_patch")
    tpatch_cli.check_config(parse(["--ckpt_backend", "orbax"]))
    with pytest.raises(ValueError, match="ckpt_backend"):
        tpatch_cli.build(parse(["--ckpt_backend", "tar", "--device", "cpu"]))


def test_missing_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tpatch_cli.Config().device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpatch_cli.build(tpatch_cli.Config())
