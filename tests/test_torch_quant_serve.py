"""The port's w8a8 ``VisualScorer`` and ``--quantize`` CLI against the JAX package, on the CPU.

One JAX-initialised XceptionLSTMV with randomised BN statistics and an
ArcFace head drive both scorers at fp32 (hidden 8, 64^2 frames, B = T = 2).
Each side calibrates implicitly on its first batch; the JAX scorer runs its
fused kernels interpreted, the port's CPU scorer their plain versions.
Bound: scores atol 1e-3.
"""
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from multimodal_deepfake_detection_tpu.core.checkpoint import save_bundle  # noqa: E402
from multimodal_deepfake_detection_tpu.models import serve as jserve  # noqa: E402
from multimodal_deepfake_detection_tpu.models.heads import (  # noqa: E402
    arcface_init,
    xception_lstm_init,
)
from multimodal_deepfake_detection_tpu_torch.cli import serve as tcli  # noqa: E402
from multimodal_deepfake_detection_tpu_torch.models.serve import VisualScorer  # noqa: E402
from multimodal_deepfake_detection_tpu_torch.utils import jax_weights  # noqa: E402

from test_torch_serve import _randomize_bn  # noqa: E402

HIDDEN = 8


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def heads():
    params, state = xception_lstm_init(jax.random.PRNGKey(0), HIDDEN)
    params, state = _np_tree(params), _np_tree(state)
    _randomize_bn(params["backbone"], state["backbone"], np.random.default_rng(0))
    arc = _np_tree(arcface_init(jax.random.PRNGKey(1), HIDDEN, 2))
    return params, state, arc


@pytest.mark.parametrize("mode", ["w8a8", "w8a8-hybrid", "w8a8-pallas"])
def test_visual_scorer_quant_matches_jax(heads, mode):
    params, state, arc = heads
    frames = np.random.default_rng(9).integers(0, 255, (2, 2, 64, 64, 3), np.uint8)
    jsc = jserve.VisualScorer(dict(params, arcface=arc), state, compute_dtype=jnp.float32,
                              use_pallas=False, quantize=mode)
    tsc = VisualScorer(jax_weights.xception_lstm_from_jax(params, state),
                       jax_weights.arcface_from_jax(arc), compute_dtype=torch.float32,
                       device="cpu", quantize=mode)
    ref = jsc.score(frames)
    got = tsc.score(frames)
    assert tsc.qbackbone is not None
    assert sum(b.k1 for b in tsc.qbackbone.blocks) == (8 if mode == "w8a8-hybrid" else 0)
    print(f"{mode}: scores {got} vs {ref}")
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)


def test_scorer_rejects_unknown_mode_and_refinement(heads):
    """An unknown mode raises; ``refine_passes > 0``, once refused, now
    refines (its parity with JAX: tests/test_torch_refine.py): only the
    epilogue's ``s_w`` and ``b`` move."""
    params, state, arc = heads
    model = jax_weights.xception_lstm_from_jax(params, state)
    head = jax_weights.arcface_from_jax(arc)
    with pytest.raises(ValueError, match="quantize must be"):
        VisualScorer(model, head, device="cpu", quantize="int4")
    frames = np.random.default_rng(3).integers(0, 255, (1, 2, 32, 32, 3), np.uint8)
    trees = []
    for passes in (0, 1):
        sc = VisualScorer(model, head, device="cpu", quantize="w8a8", compute_dtype=torch.float32)
        sc.calibrate(frames, refine_passes=passes)
        trees.append(sc.qbackbone)
    assert torch.equal(trees[0].conv1.w_q, trees[1].conv1.w_q)
    assert not torch.equal(trees[0].conv1.s_w, trees[1].conv1.s_w)
    assert not torch.equal(trees[0].conv4.pointwise.b, trees[1].conv4.pointwise.b)


def test_cli_quantize_matches_jax_scorer(heads, tmp_path):
    """``--quantize w8a8-pallas`` through the port's CLI: calibrated on the
    first batch, as the JAX scorer does implicitly."""
    params, state, arc = heads
    ck = str(tmp_path / "visual.npz")
    save_bundle(ck, {"model": params, "arcface": arc, "state": state})
    rng = np.random.default_rng(2)
    clips = [rng.integers(0, 255, (t, 32, 32, 3), np.uint8) for t in (3, 1, 2)]
    (tmp_path / "clips").mkdir()
    for i, c in enumerate(clips):
        np.save(tmp_path / "clips" / f"c{i}.npy", c)
    out = tmp_path / "scores.jsonl"
    n = tcli.main(["--ckpt_path", ck, "--input", str(tmp_path / "clips"), "--output", str(out),
                   "--batch_size", "2", "--buckets", "4", "--hidden_dim", str(HIDDEN),
                   "--compute_dtype", "float32", "--quantize", "w8a8-pallas", "--device", "cpu"],
                  log=lambda s: None)
    got = np.array([json.loads(line)["score"] for line in out.read_text().splitlines()])
    jsc = jserve.VisualScorer.from_bundle(ck, hidden_dim=HIDDEN, buckets=(4,),
                                          compute_dtype=jnp.float32, use_pallas=False,
                                          quantize="w8a8-pallas")
    ref = np.concatenate([jsc.score(*tcli._pad_stack(clips[:2])),
                          jsc.score(*tcli._pad_stack(clips[2:]))])
    assert n == 3
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)
