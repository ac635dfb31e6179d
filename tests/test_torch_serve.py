"""The port's visual serving slice against the JAX package, fp32 on the CPU.

One JAX-initialised XceptionLSTMV + ArcFace tree (randomised BN statistics,
so folding is exercised) is loaded into both packages through the weight
bridge. Bounds: per-frame features rtol 1e-3 / atol 2e-4 (the bar of
tests/test_xception.py), scores atol 1e-4.
"""
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from multimodal_deepfake_detection_tpu.core.checkpoint import save_bundle  # noqa: E402
from multimodal_deepfake_detection_tpu.models import serve as jserve  # noqa: E402
from multimodal_deepfake_detection_tpu.models.fold import folded_xception_apply  # noqa: E402
from multimodal_deepfake_detection_tpu.models.heads import (  # noqa: E402
    arcface_init,
    xception_lstm_init,
)
from multimodal_deepfake_detection_tpu_torch.cli import serve as tcli  # noqa: E402
from multimodal_deepfake_detection_tpu_torch.models.fold import fold_xception_bn  # noqa: E402
from multimodal_deepfake_detection_tpu_torch.models.serve import VisualScorer  # noqa: E402
from multimodal_deepfake_detection_tpu_torch.utils import jax_weights  # noqa: E402

HIDDEN = 8
FEAT_TOL = dict(rtol=1e-3, atol=2e-4)


def _randomize_bn(params, state, rng):
    """Random running stats and affine params on every BN, in place."""
    def walk(p, s):
        if isinstance(s, dict) and "mean" in s:
            n = s["mean"].shape
            s["mean"] = rng.normal(0, 0.1, n).astype(np.float32)
            s["var"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
            p["scale"] = rng.uniform(0.8, 1.2, n).astype(np.float32)
            p["bias"] = rng.normal(0, 0.05, n).astype(np.float32)
        elif isinstance(s, dict):
            for k in s:
                walk(p[k], s[k])
        elif isinstance(s, list):
            for a, b in zip(p, s):
                walk(a, b)
    walk(params, state)


@pytest.fixture(scope="module")
def trees():
    params, state = xception_lstm_init(jax.random.PRNGKey(0), HIDDEN)
    params = jax.tree_util.tree_map(np.asarray, params)
    state = jax.tree_util.tree_map(np.asarray, state)
    _randomize_bn(params["backbone"], state["backbone"], np.random.default_rng(0))
    arc = jax.tree_util.tree_map(np.asarray, arcface_init(jax.random.PRNGKey(1), HIDDEN, 2))
    return params, state, arc


def _port_scorer(trees, **kw):
    params, state, arc = trees
    return VisualScorer(jax_weights.xception_lstm_from_jax(params, state),
                        jax_weights.arcface_from_jax(arc), compute_dtype=torch.float32,
                        device="cpu", **kw)


def _jax_scorer(trees, **kw):
    params, state, arc = trees
    return jserve.VisualScorer(dict(params, arcface=arc), state, compute_dtype=jnp.float32,
                               use_pallas=False, **kw)


def test_weight_bridge_roundtrip(trees):
    params, state, _ = trees
    model = jax_weights.xception_lstm_from_jax(params, state)
    p2, s2 = jax_weights.xception_lstm_to_jax(model)
    flat = lambda t: jax.tree_util.tree_leaves(t)
    assert jax.tree_util.tree_structure(p2) == jax.tree_util.tree_structure(params)
    assert jax.tree_util.tree_structure(s2) == jax.tree_util.tree_structure(state)
    for a, b in zip(flat(p2) + flat(s2), flat(params) + flat(state)):
        np.testing.assert_array_equal(a, b)


def test_fold_matches_live_bn_eval(trees):
    """Folded forward == the port's own unfolded eval forward, fp32."""
    params, state, _ = trees
    model = jax_weights.xception_from_jax(params["backbone"], state["backbone"])
    folded = fold_xception_bn(model)
    x = torch.from_numpy(np.random.default_rng(1).random((2, 64, 64, 3), np.float32))
    with torch.no_grad():
        for upto in ("block4", None):
            ref = model(x, upto=upto)
            got = folded(x, upto=upto)
            np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4, atol=1e-4)
    assert sum(b.is_middle for b in folded.blocks) == 8


@pytest.mark.parametrize("size,mask_padding", [(64, True), (64, False), (32, True)])
def test_visual_scorer_matches_jax(trees, size, mask_padding):
    """64^2 gives a 4x4 middle trunk, 32^2 a 2x2 one; lengths < T and a
    bucket past T exercise both select_last_step modes."""
    frames = np.random.default_rng(size).integers(0, 255, (2, 3, size, size, 3), np.uint8)
    lengths = np.array([3, 2], np.int32)
    jsc = _jax_scorer(trees, mask_padding=mask_padding, buckets=(4,))
    tsc = _port_scorer(trees, mask_padding=mask_padding, buckets=(4,))

    x = jnp.asarray(frames.reshape(6, size, size, 3), jnp.float32) / 255.0
    ref_f = folded_xception_apply(jsc.folded_backbone, x, compute_dtype=jnp.float32,
                                  features_only=True)
    got_f = tsc.frame_features(frames).reshape(6, -1)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(ref_f), **FEAT_TOL)

    ref = jsc.score(frames, lengths)
    got = tsc.score(frames, lengths)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_bundle_from_jax_save_bundle_and_cli(trees, tmp_path):
    """A bundle written by the JAX save_bundle loads through the port's
    from_bundle and its CLI, and scores as the JAX from_bundle does."""
    params, state, arc = trees
    ck = str(tmp_path / "visual.npz")
    save_bundle(ck, {"model": params, "arcface": arc, "state": state})
    rng = np.random.default_rng(2)
    clips = [rng.integers(0, 255, (t, 32, 32, 3), np.uint8) for t in (3, 1, 2)]
    (tmp_path / "clips").mkdir()
    for i, c in enumerate(clips):
        np.save(tmp_path / "clips" / f"c{i}.npy", c)

    kw = dict(hidden_dim=HIDDEN, buckets=(4,))
    jsc = jserve.VisualScorer.from_bundle(ck, compute_dtype=jnp.float32, use_pallas=False, **kw)
    tsc = VisualScorer.from_bundle(ck, compute_dtype=torch.float32, device="cpu", **kw)
    batch, lengths = tcli._pad_stack(clips[:2])
    np.testing.assert_allclose(tsc.score(batch, lengths), jsc.score(batch, lengths),
                               rtol=0, atol=1e-4)

    out = tmp_path / "scores.jsonl"
    n = tcli.main(["--ckpt_path", ck, "--input", str(tmp_path / "clips"), "--output", str(out),
                   "--batch_size", "2", "--buckets", "4", "--hidden_dim", str(HIDDEN),
                   "--compute_dtype", "float32", "--device", "cpu"], log=lambda s: None)
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert n == len(recs) == 3
    ref = np.concatenate([jsc.score(*tcli._pad_stack(clips[:2])),
                          jsc.score(*tcli._pad_stack(clips[2:]))])
    got = np.array([r["score"] for r in recs])
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    assert [r["path"].endswith(f"c{i}.npy") for i, r in enumerate(recs)] == [True] * 3
