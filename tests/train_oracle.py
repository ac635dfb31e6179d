"""Helpers of the fp64 train-step parity tests (``tests/test_torch_train_*.py``):
run a JAX train CLI's own forward as the oracle, and compare post-step trees.

The JAX CLIs cast to their compute dtype by ``jnp.float32``, and their
models and losses cast scores, pools, probabilities and the audio logits by
``astype(jnp.float32)`` where the port casts to at least fp32. For an fp64
oracle those modules see a ``jnp`` whose ``float32`` is float64
(:func:`capture_jax_build`); at fp32 and bf16 both packages cast alike.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from multimodal_deepfake_detection_tpu.models import au_face as jau
from multimodal_deepfake_detection_tpu.models import heads as jheads
from multimodal_deepfake_detection_tpu.models import losses as jlosses
from multimodal_deepfake_detection_tpu.models import resnet_lstm as jrl

# the post-step bars of tests/test_train_step_parity.py
STEP_BARS = dict(loss=1e-12, deltas=1e-9, stats_rtol=1e-10, stats_atol=1e-12)
X64_MODULES = (jrl, jau, jheads, jlosses)  # the JAX modules with hard fp32 casts


class X64Namespace:
    """``jnp`` with ``float32`` meaning float64: the JAX CLI's compute dtype
    (``jnp.bfloat16 if ... else jnp.float32``) in an fp64 oracle run."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def randomize_buffers(model, seed):
    """Running statistics away from their init, so each update shows."""
    with torch.no_grad():
        g = torch.Generator().manual_seed(seed)
        for name, buf in model.named_buffers():
            if name.endswith("mean"):
                buf.copy_(torch.randn(buf.shape, generator=g, dtype=buf.dtype) * 0.1)
            else:
                buf.copy_(torch.rand(buf.shape, generator=g, dtype=buf.dtype) + 0.5)
    return model


def np_copy(tree):
    return jax.tree_util.tree_map(np.array, tree)


def capture_jax_build(monkeypatch, cli, inits: dict):
    """Patch the JAX CLI module: its inits return the given trees, it and
    :data:`X64_MODULES` see ``jnp.float32`` as float64, and
    ``make_train_step`` records the forward and optimizer it is given. ->
    the list the calls land in."""
    for name, tree in inits.items():
        monkeypatch.setattr(cli, name, lambda *a, _t=tree, **kw: jax.tree_util.tree_map(
            jnp.asarray, _t))
    for module in (cli,) + X64_MODULES:
        monkeypatch.setattr(module, "jnp", X64Namespace())
    calls = []
    real = cli.make_train_step

    def capture(fwd, tx, **kw):
        calls.append((fwd, tx, kw))
        return real(fwd, tx, **kw)

    monkeypatch.setattr(cli, "make_train_step", capture)
    monkeypatch.setenv("MDD_NO_COMPILE_CACHE", "1")
    return calls


def no_dropout(fwd):
    return lambda p, bn, rng, batch: fwd(p, bn, None, batch)


def assert_scaled(ref: dict, got: dict, p0: dict, atol=STEP_BARS["deltas"]):
    """Each tensor's change from ``p0``, over the larger of its largest in
    either package and 1e-6 of the largest overall, within ``atol``."""
    assert set(ref) == set(got) == set(p0)
    deltas = {k: (ref[k] - p0[k], got[k] - p0[k]) for k in p0}
    top = max(np.abs(dj).max() for dj, _ in deltas.values())
    assert top > 0
    for k, (dj, dt) in sorted(deltas.items()):
        scale = max(np.abs(dt).max(), np.abs(dj).max(), 1e-6 * top)
        np.testing.assert_allclose(dt / scale, dj / scale, rtol=0, atol=atol, err_msg=k)


def assert_stats(ref: dict, got: dict, before: dict):
    assert set(ref) == set(got) == set(before)
    for k in sorted(ref):
        np.testing.assert_allclose(got[k], ref[k], rtol=STEP_BARS["stats_rtol"],
                                   atol=STEP_BARS["stats_atol"], err_msg=k)
        assert np.any(got[k] != before[k]), k
