"""The port's visual train step against the JAX package's, one SGD step.

The port's ``cli/train_visual.make_forward`` under its
``train.steps.make_train_step``, and the JAX ``train_visual`` forward under
JAX's ``make_train_step`` (optax SGD), start from the same full-width
XceptionLSTMV + ArcFace weights (hidden 128) and take one step on the same
seed-made batch (B=2, T=2, 32^2, one clip padded), in float64: BN in
batch-statistics mode with the single-pass variance, the sample-weighted
cross-entropy on the margin logits, the masked last LSTM step. Unfrozen and
with ``frozen_keys=("backbone",)``. Bars, those of
``tests/test_train_step_parity.py``: the loss rtol 1e-12; every post-step
parameter delta, scaled by the larger of its tensor's largest delta in
either package and 1e-6 of the largest delta overall, within atol 1e-9; the
running BN statistics rtol 1e-10 / atol 1e-12.

Also ``remat=True`` against ``remat=False`` in the port (fp32): the same
gradients and post-step running statistics, bit for bit, so each BN's
running statistics were updated once although the checkpointed blocks ran
their forward twice.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_deepfake_detection_tpu.models.heads import (
    arcface_apply as jax_arcface_apply,
    xception_lstm_embed as jax_embed,
    xception_lstm_features as jax_features,
)
from multimodal_deepfake_detection_tpu.models.losses import cross_entropy_loss as jax_ce
from multimodal_deepfake_detection_tpu.train import TrainState as JaxTrainState
from multimodal_deepfake_detection_tpu.train.steps import make_train_step as jax_make_train_step
from multimodal_deepfake_detection_tpu_torch.cli import train_visual as tv
from multimodal_deepfake_detection_tpu_torch.models.heads import XceptionLSTMArcFace
from multimodal_deepfake_detection_tpu_torch.train import TrainState
from multimodal_deepfake_detection_tpu_torch.train.optim import Optimizer
from multimodal_deepfake_detection_tpu_torch.train.steps import make_train_step
from multimodal_deepfake_detection_tpu_torch.utils.jax_weights import (
    arcface_to_jax,
    xception_lstm_to_jax,
)

HIDDEN, S, M, LR = 128, 30.0, 0.5, 0.05
B, T, SIZE = 2, 2, 32


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch on one intra-op thread for these tests, restored after: the fp64
    grouped convolutions run one small convolution per channel, and with
    several threads each is a parallel region (3x slower on an idle CPU, far
    slower beside other test processes)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@contextlib.contextmanager
def enable_x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flatten(v, f"{prefix}{k}.").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in _flatten(v, f"{prefix}{i}.").items()}
    return {prefix[:-1]: np.asarray(tree)}


def _export(model):
    """Copies: the bridge's numpy leaves may share the parameters' memory."""
    params, state = xception_lstm_to_jax(model)
    params["arcface"] = arcface_to_jax(model.arcface)
    return jax.tree_util.tree_map(np.array, (params, state))


def _batch():
    rng = np.random.default_rng(0)
    video = rng.uniform(0, 1, (B, T, SIZE, SIZE, 3))
    return video, np.array([0.0, 1.0]), np.array([T, 1], np.int32)


def _model(seed=0, dtype=torch.float64):
    model = XceptionLSTMArcFace(HIDDEN, generator=torch.Generator().manual_seed(seed)).to(dtype)
    with torch.no_grad():  # running statistics away from their init, so the update shows
        g = torch.Generator().manual_seed(seed + 1)
        for name, buf in model.named_buffers():
            if name.endswith("mean"):
                buf.copy_(torch.randn(buf.shape, generator=g) * 0.1)
            else:
                buf.copy_(torch.rand(buf.shape, generator=g) + 0.5)
    return model


def _port_step(model, batch, frozen_keys, remat=False, dtype=torch.float64):
    forward = tv.make_forward(tv.Config(remat=remat), dtype)

    def loss_forward(m, rng_seed, b):
        loss, bn_stats, probs = forward(m, b, True)
        return loss, (bn_stats, probs)

    state = TrainState(0, model, Optimizer(torch.optim.SGD(model.parameters(), lr=LR)))
    video, labels, lengths = batch
    tb = (torch.from_numpy(video).to(dtype), torch.from_numpy(labels), torch.from_numpy(lengths))
    _, loss, probs = make_train_step(loss_forward)(state, tb, 0, frozen_keys)
    return float(loss)


def _jax_step(params, bn_state, batch, frozen_keys):
    def train_forward(p, bn, rng, b):  # the JAX train_visual._forward, train=True
        vid, lab, lens = b
        feats, new_bn = jax_features(p, bn, vid, mode="video", train=True,
                                     compute_dtype=jnp.float64)
        emb = jax_embed(p, feats, lengths=lens, mask_padding=True, compute_dtype=jnp.float64)
        li = lab.astype(jnp.int32)
        logits = jax_arcface_apply(p["arcface"], emb, li, s=S, m=M)
        loss = jax_ce(logits, li, sample_weight=(lens > 0).astype(jnp.float32))
        return loss, (new_bn, jax.nn.softmax(logits, axis=-1)[:, 1])

    tx = optax.sgd(LR)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    bn = jax.tree_util.tree_map(jnp.asarray, bn_state)
    state = JaxTrainState(jnp.zeros((), jnp.int32), p, bn, tx.init(p))
    new_state, loss, _ = jax_make_train_step(train_forward, tx)(
        state, tuple(jnp.asarray(a) for a in batch), 0, frozen_keys)
    return (float(loss), jax.tree_util.tree_map(np.asarray, new_state.params),
            jax.tree_util.tree_map(np.asarray, new_state.bn_state))


@pytest.mark.parametrize("frozen_keys", [(), ("backbone",)], ids=["unfrozen", "frozen_backbone"])
def test_visual_train_step_matches_jax_fp64(frozen_keys):
    model = _model()
    p0, s0 = _export(model)
    batch = _batch()
    t_loss = _port_step(model, batch, frozen_keys)
    t_params, t_state = _export(model)
    with enable_x64():
        j_loss, j_params, j_state = _jax_step(p0, s0, batch, frozen_keys)
    np.testing.assert_allclose(t_loss, j_loss, rtol=1e-12)

    f0, ft, fj = _flatten(p0), _flatten(t_params), _flatten(j_params)
    assert set(ft) == set(fj) == set(f0)
    deltas = {k: (fj[k] - f0[k], ft[k] - f0[k]) for k in f0}
    global_scale = max(np.abs(dt).max() for _dj, dt in deltas.values())
    assert global_scale > 0
    for k, (dj, dt) in sorted(deltas.items()):
        scale = max(np.abs(dt).max(), np.abs(dj).max(), 1e-6 * global_scale)
        np.testing.assert_allclose(dt / scale, dj / scale, rtol=0, atol=1e-9, err_msg=k)
    if frozen_keys:
        assert all(not np.any(ft[k] - f0[k]) for k in ft if k.startswith("backbone."))

    sj, st, s00 = _flatten(j_state), _flatten(t_state), _flatten(s0)
    assert set(sj) == set(st)
    for k in sorted(sj):
        np.testing.assert_allclose(st[k], sj[k], rtol=1e-10, atol=1e-12, err_msg=k)
        assert np.any(st[k] != s00[k]), k  # every running statistic moved


def test_remat_matches_plain_and_updates_running_stats_once():
    batch = _batch()
    got = {}
    for remat in (False, True):
        model = _model(dtype=torch.float32)
        _port_step(model, batch, (), remat=remat, dtype=torch.float32)
        got[remat] = ({n: p.grad.clone() for n, p in model.named_parameters()},
                      {n: b.clone() for n, b in model.named_buffers()})
    for a, b in zip(got[False], got[True]):
        assert set(a) == set(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_audio_mode_features_match_jax():
    """``xception_lstm_features(mode="audio")``: (B, T, 3, 13) MFCC steps,
    each resized to a 64^2 image, through the eval backbone; fp32 at the
    backbone bar of ``tests/test_xception.py`` (rtol 1e-3 / atol 2e-4)."""
    from multimodal_deepfake_detection_tpu_torch.models.heads import xception_lstm_features

    model = _model(dtype=torch.float32)
    p0, s0 = _export(model)
    mfcc = np.random.default_rng(5).normal(0, 20, (1, 2, 3, 13)).astype(np.float32)
    with torch.no_grad():
        got, stats = xception_lstm_features(model, torch.from_numpy(mfcc), mode="audio")
    want, _ = jax.jit(lambda p, s, x: jax_features(p, s, x, mode="audio"))(
        jax.tree_util.tree_map(jnp.asarray, p0), jax.tree_util.tree_map(jnp.asarray, s0),
        jnp.asarray(mfcc))
    assert stats == [] and got.shape == (1, 2, 2048)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=2e-4)
