"""The port's audio trainer against the JAX package's.

* One step of ``cli/train_audio``'s forward under its ``make_train_step``
  against the JAX CLI's own forward, captured from its ``build()`` (the
  initial weights the port's: a full-width Xception, hidden 8), under JAX's
  ``make_train_step``: SGD, fp64, dropout off (no generator; ``rng=None`` in
  JAX), the backbone frozen (``frozen_keys=("backbone",)``) with its BN on
  batch statistics, B=2 x T=2 MFCC steps, one clip padded. The JAX CLI,
  head and BCE cast by ``jnp.float32`` (the compute dtype, the logits before
  the sigmoid, the probabilities) where the port casts to at least fp32, so
  for the fp64 oracle those modules see a ``jnp`` whose ``float32`` is
  float64. Bars, those of
  ``tests/test_torch_train_step.py``: the loss rtol 1e-12; each post-step
  delta, scaled by the larger of its tensor's largest delta in either
  package and 1e-6 of the largest overall, atol 1e-9 (the backbone's
  exactly 0); every running statistic moved, rtol 1e-10 / atol 1e-12.
* ``--backbone_bn_eval true``: the running statistics stay as they were.
* The CLI on the CPU, fp32, 2 epochs on a synthetic MFCC tree (hidden 8),
  plain and with ``--cache_features true``: each best bundle loads strictly
  into both packages' ``AudioScorer.from_bundle``, and both score the same
  waveforms within 1e-4. The flags that wait for another item raise and
  name it; ``--device cuda`` raises without CUDA.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_deepfake_detection_tpu.cli import train_audio as jaudio_cli
from multimodal_deepfake_detection_tpu.core.checkpoint import load_bundle, merge_params
from multimodal_deepfake_detection_tpu.models import heads as jheads
from multimodal_deepfake_detection_tpu.models import losses as jlosses
from multimodal_deepfake_detection_tpu.models import serve as jserve
from multimodal_deepfake_detection_tpu.train import TrainState as JaxTrainState
from multimodal_deepfake_detection_tpu.train.steps import make_train_step as jax_make_train_step
from multimodal_deepfake_detection_tpu_torch.cli import train_audio as taudio_cli
from multimodal_deepfake_detection_tpu_torch.data.datasets import NpyFolderDataset
from multimodal_deepfake_detection_tpu_torch.data.synthetic import make_audio_npy_tree
from multimodal_deepfake_detection_tpu_torch.models.heads import XceptionLSTM
from multimodal_deepfake_detection_tpu_torch.models.serve import AudioScorer
from multimodal_deepfake_detection_tpu_torch.train import TrainState
from multimodal_deepfake_detection_tpu_torch.train.optim import Optimizer
from multimodal_deepfake_detection_tpu_torch.train.steps import make_train_step
from multimodal_deepfake_detection_tpu_torch.utils.jax_weights import xception_lstm_to_jax

from train_oracle import (
    X64Namespace,
    assert_scaled,
    assert_stats,
    no_dropout,
    np_copy,
    randomize_buffers,
)
from test_torch_train_step import _flatten, enable_x64, one_torch_thread  # noqa: F401

LR, HIDDEN = 0.05, 8


@pytest.fixture(scope="module")
def audio_root(tmp_path_factory):
    return make_audio_npy_tree(str(tmp_path_factory.mktemp("mfcc")), n_per_class=2, frames=5,
                               seed=2)


def _batch():
    rng = np.random.default_rng(4)
    return rng.normal(0, 20, (2, 2, 3, 13)), np.array([0.0, 1.0]), np.array([2, 1], np.int32)


def _loss_forward(cfg, bb_eval):
    forward = taudio_cli.make_forward(cfg, torch.float64, bb_eval)

    def loss_forward(m, rng_seed, b):
        loss, stats, probs = forward(m, b, True)
        return loss, (stats, probs)
    return loss_forward


def _port_step(model, batch, bb_eval=False):
    state = TrainState(0, model, Optimizer(torch.optim.SGD(model.parameters(), lr=LR)))
    x, labels, lengths = (torch.from_numpy(a) for a in batch)
    _, loss, _ = make_train_step(_loss_forward(taudio_cli.Config(), bb_eval))(
        state, (x, labels, lengths), 0, ("backbone",))
    return float(loss)


def test_audio_step_matches_jax_fp64(audio_root, monkeypatch, one_torch_thread):
    model = randomize_buffers(XceptionLSTM(HIDDEN, generator=torch.Generator().manual_seed(3))
                              .double(), 4)
    p0, s0 = np_copy(xception_lstm_to_jax(model))
    batch = _batch()
    t_loss = _port_step(model, batch)
    t_params, t_state = xception_lstm_to_jax(model)

    monkeypatch.setattr(jaudio_cli, "xception_lstm_init",
                        lambda *a, **kw: jax.tree_util.tree_map(jnp.asarray, (p0, s0)))
    for module in (jaudio_cli, jheads, jlosses):
        monkeypatch.setattr(module, "jnp", X64Namespace())
    calls = []
    monkeypatch.setattr(jaudio_cli, "make_train_step",
                        lambda fwd, tx, **kw: calls.append(fwd) or (lambda *a: None))
    ds = NpyFolderDataset(os.path.join(audio_root, "train"), kind="audio")
    cfg = jaudio_cli.Config(hidden_dim=HIDDEN, batch_size=2, compute_dtype="float32")
    assert cfg.freeze_backbone and not cfg.backbone_bn_eval
    with enable_x64():
        jaudio_cli.build(cfg, ds, ds)
        tx = optax.sgd(LR)
        p = jax.tree_util.tree_map(jnp.asarray, p0)
        jstate = JaxTrainState(jnp.zeros((), jnp.int32), p,
                               jax.tree_util.tree_map(jnp.asarray, s0), tx.init(p))
        new, j_loss, _ = jax_make_train_step(no_dropout(calls[0]), tx)(
            jstate, jax.tree_util.tree_map(jnp.asarray, batch), 0, ("backbone",))
        j_params, j_state, j_loss = np_copy(new.params), np_copy(new.bn_state), float(j_loss)
    np.testing.assert_allclose(t_loss, j_loss, rtol=1e-12)
    ft = _flatten(t_params)
    assert all(not np.any(ft[k] - _flatten(p0)[k]) for k in ft if k.startswith("backbone."))
    assert_scaled(_flatten(j_params), ft, _flatten(p0))
    assert_stats(_flatten(j_state), _flatten(t_state), _flatten(s0))


def test_backbone_bn_eval_keeps_running_stats():
    model = randomize_buffers(XceptionLSTM(HIDDEN, generator=torch.Generator().manual_seed(3)), 4)
    before = {n: b.clone() for n, b in model.named_buffers()}
    x, labels, lengths = _batch()
    batch = (x.astype(np.float32), labels.astype(np.float32), lengths)
    forward = taudio_cli.make_forward(taudio_cli.Config(), torch.float32, True)
    state = TrainState(0, model, Optimizer(torch.optim.SGD(model.parameters(), lr=LR)))

    def loss_forward(m, rng_seed, b):
        loss, stats, probs = forward(m, b, True)
        assert stats == []
        return loss, (stats, probs)

    make_train_step(loss_forward)(state, tuple(torch.from_numpy(a) for a in batch), 0,
                                  ("backbone",))
    for n, b in model.named_buffers():
        assert torch.equal(b, before[n]), n


@functools.lru_cache(maxsize=None)
def _template_shapes(hidden_dim):
    return jax.eval_shape(lambda r: jheads.xception_lstm_init(r, hidden_dim),
                          jax.random.PRNGKey(0))


@pytest.mark.parametrize("extra", [(), ("--cache_features", "true")],
                         ids=["plain", "cache_features"])
def test_train_audio_cli_bundle_serves_in_both_packages(audio_root, tmp_path, extra, monkeypatch,
                                                        one_torch_thread):
    shapes = _template_shapes(HIDDEN)
    zeros = jax.tree_util.tree_map(lambda a: jnp.zeros(a.shape, a.dtype), shapes)
    monkeypatch.setattr(jheads, "xception_lstm_init", lambda rng, hidden_dim: zeros)
    logs = []
    history = taudio_cli.main(
        ["--train_folder", f"{audio_root}/train", "--eval_folder", f"{audio_root}/eval",
         "--checkpoint_dir", str(tmp_path), "--epochs", "2", "--eval_every", "1",
         "--hidden_dim", str(HIDDEN), "--batch_size", "2", "--buckets", "5",
         "--compute_dtype", "float32", "--device", "cpu", *extra], log=logs.append)
    assert len(history) == 2 and all(np.isfinite(r.train_loss) for r in history)
    assert os.path.exists(tmp_path / "train_audio_state.pt")
    path = str(tmp_path / taudio_cli.BUNDLE_NAME)
    bundle = load_bundle(path)
    merge_params(shapes[0], bundle["model"], strict=True)
    merge_params(shapes[1], bundle["state"], strict=True)
    waves = np.random.default_rng(5).normal(0, 0.1, (2, 960)).astype(np.float32)
    jsc = jserve.AudioScorer.from_bundle(path, hidden_dim=HIDDEN, compute_dtype=jnp.float32,
                                         use_pallas=False)
    tsc = AudioScorer.from_bundle(path, hidden_dim=HIDDEN, compute_dtype=torch.float32,
                                  device="cpu")
    np.testing.assert_allclose(tsc.score(waves), jsc.score(waves), rtol=0, atol=1e-4)


def test_native_loader_builds(tmp_path):
    """``--native_loader true`` builds the CLI on the C++ npy collate
    (``data/native_loader.py``): the train and eval batches are the Python
    loader's, bit for bit."""
    from multimodal_deepfake_detection_tpu_torch.data.native_loader import _IndexDataset

    tree = make_audio_npy_tree(str(tmp_path), n_per_class=2, frames=5, seed=9)
    argv = ["--train_folder", tree + "/train", "--eval_folder", tree + "/eval", "--buckets", "6",
            "--hidden_dim", str(HIDDEN), "--device", "cpu"]
    parse = lambda extra: taudio_cli.parse_config(taudio_cli.Config, argv + extra,  # noqa: E731
                                                  prog="train_audio")
    native = taudio_cli.build(parse(["--native_loader", "true"]))
    python = taudio_cli.build(parse([]))
    assert isinstance(native[0].dataset, _IndexDataset)
    for got, want in ((native[0], python[0]), (native[1], python[1])):
        pairs = list(zip(got, want))
        assert len(pairs) == len(want) > 0
        for g, w in pairs:
            for a, b in zip(g, w):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("argv,err,match", [
    (["--ckpt_backend", "orbax"], NotImplementedError, "item 11"),
    (["--cache_features", "true", "--freeze_backbone", "false"], ValueError, "freeze_backbone"),
])
def test_unported_flags_raise(argv, err, match):
    with pytest.raises(err, match=match):
        taudio_cli.build(taudio_cli.parse_config(taudio_cli.Config, argv + ["--device", "cpu"],
                                                 prog="train_audio"))


def test_missing_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert taudio_cli.Config().device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        taudio_cli.build(taudio_cli.Config())
