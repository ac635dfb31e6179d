"""The fp path's kernel routes against the JAX package, on the CPU:
``middle_taps="bf16"`` (K1 in ``middle_block_pallas_v2(precise=False)``'s tap
order), ``entry_pair`` (K4 for the stride-2 blocks' pairs, pool and skip on
the plain convs) and ``fuse_exit`` (K5 for conv3 and conv4).

On a CPU tensor ``use_kernels=True`` runs each kernel's plain version. Each
route's 64^2 backbone is held against the JAX forward that runs the JAX
package's own kernel for it, in interpret mode, fp32 activations:
``folded_xception_apply(use_pallas=True)`` with the image-major middle
layout and v2's ``precise=False``; the same forward up to block 12, then
``sepconv_unit_pallas`` for conv3 and conv4; and the split of
``tools/microbench.py`` (``entry_pair`` + max pool + skip conv) for the
stride-2 blocks. Both sides round at the same points; each bound is stated
at its test. ``VisualScorer`` with each route is held against the JAX
``VisualScorer``'s scores (``use_pallas=False``, fp32), which round nowhere.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from multimodal_deepfake_detection_tpu.models import serve as jserve  # noqa: E402
from multimodal_deepfake_detection_tpu.models.fold import (  # noqa: E402
    _sep_apply,
    folded_xception_apply,
)
from multimodal_deepfake_detection_tpu.models.fold import (  # noqa: E402
    fold_xception_bn as jax_fold_xception_bn,
)
from multimodal_deepfake_detection_tpu.models.heads import (  # noqa: E402
    arcface_init,
    xception_lstm_init,
)
from multimodal_deepfake_detection_tpu.models.xception import XCEPTION_BLOCK_SPECS  # noqa: E402
from multimodal_deepfake_detection_tpu.ops.conv import (  # noqa: E402
    conv2d,
    global_avg_pool,
    max_pool2d,
)
from multimodal_deepfake_detection_tpu.ops.pallas import sepconv_block  # noqa: E402
from multimodal_deepfake_detection_tpu.ops.pallas.sepconv_entry import (  # noqa: E402
    entry_pair as jax_entry_pair,
)
from multimodal_deepfake_detection_tpu.ops.pallas.sepconv_stream import (  # noqa: E402
    pack_pair as jax_pack_pair,
)
from multimodal_deepfake_detection_tpu.ops.pallas.sepconv_unit import (  # noqa: E402
    pack_unit as jax_pack_unit,
)
from multimodal_deepfake_detection_tpu.ops.pallas.sepconv_unit import (  # noqa: E402
    sepconv_unit_pallas,
)
from multimodal_deepfake_detection_tpu_torch.cli import serve as tcli  # noqa: E402
from multimodal_deepfake_detection_tpu_torch.models import fold as tfold  # noqa: E402
from multimodal_deepfake_detection_tpu_torch.models.heads import (  # noqa: E402
    ArcFace,
    XceptionLSTM,
)
from multimodal_deepfake_detection_tpu_torch.models.serve import VisualScorer  # noqa: E402
from multimodal_deepfake_detection_tpu_torch.utils import jax_weights  # noqa: E402

HIDDEN = 8
ROUTES = {"middle_taps": dict(middle_taps="bf16"), "entry_pair": dict(entry_pair=True),
          "fuse_exit": dict(fuse_exit=True)}


def _randomize_bn(params, state, rng):
    """Random running stats and affine params on every BN, in place."""
    if isinstance(state, dict) and "mean" in state:
        n = state["mean"].shape
        state["mean"] = rng.normal(0, 0.1, n).astype(np.float32)
        state["var"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
        params["scale"] = rng.uniform(0.8, 1.2, n).astype(np.float32)
        params["bias"] = rng.normal(0, 0.05, n).astype(np.float32)
    elif isinstance(state, dict):
        for k in state:
            _randomize_bn(params[k], state[k], rng)
    elif isinstance(state, list):
        for p, s in zip(params, state):
            _randomize_bn(p, s, rng)


@pytest.fixture(scope="module")
def trees():
    params, state = xception_lstm_init(jax.random.PRNGKey(5), HIDDEN)
    params = jax.tree_util.tree_map(np.asarray, params)
    state = jax.tree_util.tree_map(np.asarray, state)
    _randomize_bn(params["backbone"], state["backbone"], np.random.default_rng(0))
    arc = jax.tree_util.tree_map(np.asarray, arcface_init(jax.random.PRNGKey(6), HIDDEN, 2))
    return params, state, arc


@pytest.fixture(scope="module")
def backbone(trees):
    """(JAX fold, the port's fp32 fold, 2 frames at 64^2)."""
    params, state, _ = trees
    jfold = jax_fold_xception_bn(params["backbone"], state["backbone"])
    tf = tfold.fold_xception_bn(jax_weights.xception_from_jax(params["backbone"],
                                                              state["backbone"]))
    x = np.random.default_rng(1).random((2, 64, 64, 3), np.float32)
    return jfold, tf, x


def _port(folded, x, monkeypatch, kernel, **route):
    """The port's features with ``use_kernels=True`` and ``route``; counts the
    calls of ``kernel`` (a name in ``models/fold.py``)."""
    calls = []
    fn = getattr(tfold, kernel)
    monkeypatch.setattr(tfold, kernel, lambda *a, **k: calls.append(k) or fn(*a, **k))
    with torch.no_grad():
        got = folded(torch.from_numpy(x), features_only=True, use_kernels=True, **route)
    return got.numpy(), calls


def _held(got, ref, tol, label):
    ref = np.asarray(ref)
    print(f"{label}: features max|d|={np.abs(got - ref).max():.3e} "
          f"(max|ref|={np.abs(ref).max():.3e})")
    np.testing.assert_allclose(got, ref, **tol)


# Feature bound of the three backbone tests: both sides round at the same
# points; CPU runs read max|d| 6.0e-8 (middle_taps, entry_pair) and 1.7e-6
# (fuse_exit) at features up to 0.40 (an fp32 summation-order flip before a
# bf16 cast carries through the later layers). atol 2e-5 / rtol 1e-4, as for
# the fused-entry backbone (tests/test_torch_entry_block.py).
SLICE_TOL = dict(rtol=1e-4, atol=2e-5)


def test_middle_taps_bf16_backbone_matches_jax_v2_route(backbone, monkeypatch):
    """The JAX ``use_pallas=True`` route with ``MDFD_MIDDLE_LAYOUT=hw`` runs
    every middle block through ``middle_block_pallas_v2``; here with
    ``precise=False``."""
    jfold, tf, x = backbone
    monkeypatch.setenv("MDFD_MIDDLE_LAYOUT", "hw")
    monkeypatch.delenv("MDFD_ENTRY_FUSE_H", raising=False)
    v2 = sepconv_block.middle_block_pallas_v2
    monkeypatch.setattr(sepconv_block, "middle_block_pallas_v2",
                        lambda *a, **k: v2(*a, **dict(k, precise=False)))
    ref = folded_xception_apply(jfold, jnp.asarray(x), features_only=True, use_pallas=True,
                                pallas_interpret=True)
    got, calls = _port(tf, x, monkeypatch, "middle_block", middle_taps="bf16")
    assert [k["taps"] for k in calls] == ["bf16"] * 8
    _held(got, ref, SLICE_TOL, "middle_taps=bf16")


def test_fuse_exit_backbone_matches_jax_unit_route(backbone, monkeypatch):
    """conv3 and conv4 through ``sepconv_unit_pallas`` (no leading ReLU, the
    trailing one fused), after the JAX ``use_pallas=True`` forward up to
    block 12 (the middle flow through the JAX K1, as the port's runs). The
    JAX kernel multiplies by ``pw`` in the dtype it is given, so it gets the
    fold's pointwise weights rounded to bf16, as K5 takes them."""
    jfold, tf, x = backbone
    monkeypatch.delenv("MDFD_MIDDLE_LAYOUT", raising=False)
    monkeypatch.delenv("MDFD_ENTRY_FUSE_H", raising=False)
    h = folded_xception_apply(jfold, jnp.asarray(x), use_pallas=True, pallas_interpret=True,
                              upto="block12")
    for conv in ("conv3", "conv4"):
        dw, pw, b = jax_pack_unit(jfold[conv])
        h = sepconv_unit_pallas(h, dw, pw.astype(jnp.bfloat16).astype(jnp.float32), b,
                                leading_relu=False, trailing_relu=True, interpret=True)
    got, calls = _port(tf, x, monkeypatch, "sepconv_unit", fuse_exit=True)
    assert calls == [dict(leading_relu=False, trailing_relu=True)] * 2
    _held(got, global_avg_pool(h), SLICE_TOL, "fuse_exit")


def _jax_entry_pair_route(jfold, x):
    """The JAX folded forward with every stride-2 block split as
    tools/microbench.py times it: ``entry_pair`` (K4), then the max pool and
    the skip conv; the middle flow through ``middle_block_pallas`` (v1, K1's
    function), stem and exit as ``folded_xception_apply``."""
    h = folded_xception_apply(jfold, x, upto="stem")
    for spec, bp in zip(XCEPTION_BLOCK_SPECS, jfold["blocks"]):
        stride, lead = spec[3], spec[4]
        if "skip" in bp:
            assert stride == 2 and len(bp["units"]) == 2
            pair = jax_entry_pair(h, *jax_pack_pair(bp), leading_relu0=lead, row_chunk=512,
                                  interpret=True)
            h = max_pool2d(pair, 3, 2, 1) + conv2d(bp["skip"], h, stride=2, padding=0)
        else:
            assert sepconv_block.is_middle_block(bp) and lead
            h = sepconv_block.middle_block_pallas(h, *sepconv_block.pack_middle_block(bp),
                                                  interpret=True)
    for conv in ("conv3", "conv4"):
        h = jax.nn.relu(_sep_apply(jfold[conv], h, None))
    return global_avg_pool(h)


def test_entry_pair_backbone_matches_jax_pair_route(backbone, monkeypatch):
    jfold, tf, x = backbone
    ref = _jax_entry_pair_route(jfold, jnp.asarray(x))
    got, calls = _port(tf, x, monkeypatch, "_entry_pair", entry_pair=True)
    assert [k["leading_relu0"] for k in calls] == [False, True, True, True]
    assert [k for k, b in enumerate(tf.blocks) if b.is_entry] == [0, 1, 2, 11]
    _held(got, ref, SLICE_TOL, "entry_pair")


@pytest.fixture(scope="module")
def jax_scores(trees):
    params, state, arc = trees
    frames = np.random.default_rng(3).integers(0, 255, (2, 3, 64, 64, 3), np.uint8)
    lengths = np.array([3, 2], np.int32)
    jsc = jserve.VisualScorer(dict(params, arcface=arc), state, compute_dtype=jnp.float32,
                              use_pallas=False, buckets=(4,))
    return frames, lengths, jsc.score(frames, lengths)


# Score bound of each route's VisualScorer against the JAX scorer, which
# rounds nowhere: the routes round activations to bf16 inside the kernels.
# On this random model the head washes that out (CPU runs read score |d| <=
# 4.5e-9); the bound is the plain slice's (tests/test_torch_serve.py).
SCORE_TOL = 1e-4


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_visual_scorer_route_matches_jax_scores(trees, jax_scores, route):
    params, state, arc = trees
    frames, lengths, ref = jax_scores
    scorer = VisualScorer(jax_weights.xception_lstm_from_jax(params, state),
                          jax_weights.arcface_from_jax(arc), compute_dtype=torch.float32,
                          use_kernels=True, buckets=(4,), device="cpu", **ROUTES[route])
    got = scorer.score(frames, lengths)
    print(f"{route}: score max|d|={np.abs(got - ref).max():.3e}")
    np.testing.assert_allclose(got, ref, rtol=0, atol=SCORE_TOL)


def test_cli_route_flags():
    cfg = tcli.parse_config([])
    assert (cfg.middle_taps, cfg.entry_pair, cfg.fuse_exit) == ("fp32", False, False)
    cfg = tcli.parse_config(["--middle_taps", "bf16", "--entry_pair", "true",
                             "--fuse_exit", "true"])
    assert (cfg.middle_taps, cfg.entry_pair, cfg.fuse_exit) == ("bf16", True, True)


def _small_model():
    g = torch.Generator().manual_seed(0)
    return XceptionLSTM(8, generator=g), ArcFace(8, 2, generator=g)


@pytest.mark.parametrize("route,quantize", [
    ("middle_taps", "w8a8-pallas"), ("entry_pair", "w8a8"), ("fuse_exit", "w8a8-hybrid"),
])
def test_route_with_quantize_raises(route, quantize):
    """The w8a8 walk has none of these routes, so the port refuses the pair."""
    with pytest.raises(ValueError, match=route):
        VisualScorer(*_small_model(), quantize=quantize, device="cpu", **ROUTES[route])


def test_entry_pair_with_fuse_entry_raises(backbone):
    """K3 and K4 both claim the stride-2 blocks."""
    with pytest.raises(ValueError, match="fuse_entry"):
        VisualScorer(*_small_model(), entry_pair=True, fuse_entry=True, device="cpu")
    _, tf, x = backbone
    with pytest.raises(ValueError, match="entry_pair"):
        tf(torch.from_numpy(x), use_kernels=True, entry_pair=True, fuse_entry=True)
    with pytest.raises(ValueError, match="middle_taps"):
        tf(torch.from_numpy(x), use_kernels=True, middle_taps="fp16")
