"""The port's w8a8 Xception (models/quant.py) against the JAX package, on the CPU.

One JAX-initialised Xception with randomised BN statistics is folded by the
JAX package (fp32) and carried across with the tree bridge, so both
packages calibrate, quantize and walk the same fp32 folded weights. Bounds:

* calibration amaxes: every site at rtol 1e-4;
* tree build from the same amaxes: >= 99.99 % of the int8 codes equal, none
  off by more than 1, scales at rtol 1e-5 (``a ** 0.5`` and the divides may
  round one ulp apart between XLA and PyTorch, which can move a code at a .5
  tie);
* one JAX qtree driving both walks (fp32, 64^2: a 4x4 trunk, where the JAX
  walk takes its fused kernels): per-frame feature cosine >= 0.9999 and
  features within 1e-2 of their max |f|.

The scorers and the CLI are held against the JAX package in
test_torch_quant_serve.py.
"""
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from multimodal_deepfake_detection_tpu.models import quant as jquant  # noqa: E402
from multimodal_deepfake_detection_tpu.models.fold import fold_xception_bn as jfold  # noqa: E402
from multimodal_deepfake_detection_tpu.models.xception import xception_init  # noqa: E402
from multimodal_deepfake_detection_tpu.ops.pallas.sepconv_pos import (  # noqa: E402
    pack_middle_block_q as jax_pack_middle_block_q,
)
from multimodal_deepfake_detection_tpu_torch.models import quant as tquant  # noqa: E402
from multimodal_deepfake_detection_tpu_torch.models.fold import fold_xception_bn  # noqa: E402
from multimodal_deepfake_detection_tpu_torch.ops.quant import conv2d_w8a8  # noqa: E402
from multimodal_deepfake_detection_tpu_torch.utils import jax_weights  # noqa: E402

from test_torch_serve import _randomize_bn  # noqa: E402


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    params, state = xception_init(jax.random.PRNGKey(3), num_classes=None)
    params, state = _np_tree(params), _np_tree(state)
    _randomize_bn(params, state, np.random.default_rng(3))
    folded = _np_tree(jfold(params, state))
    x = np.random.default_rng(4).random((4, 64, 64, 3), np.float32)
    amaxes = jquant.calibrate_amax(folded, jnp.asarray(x), compute_dtype=jnp.float32)
    return params, state, folded, x, amaxes


@pytest.fixture(scope="module")
def jax_qtree(setup):
    """The JAX package's w8a8 tree (``quant_depthwise=True``) of the folded
    weights, built once per ``(act_scales, skip_middle)``."""
    _, _, folded, _, amaxes = setup

    @functools.cache
    def build(act_scales="channel", skip_middle=False):
        return _np_tree(jquant.quantize_folded_xception(
            folded, amaxes, quant_depthwise=True, skip_middle=skip_middle, act_scales=act_scales))

    return build


def _walk_jax(qtree, x, **kw):
    return np.asarray(jquant.xception_quant_walk(qtree, jnp.asarray(x), compute_dtype=jnp.float32,
                                                 features_only=True, **kw), np.float32)


def _walk_port(tree, x, **kw):
    with torch.no_grad():
        return tquant.xception_quant_walk(tree, torch.from_numpy(x), compute_dtype=torch.float32,
                                          features_only=True, **kw).numpy()


def test_fp_walk_equals_folded_forward(setup):
    """``quant=False`` over the fp tree is ``FoldedXception.forward``, bit for
    bit, at fp32 and bf16 (weights cast per call there, stored cast here)."""
    params, state, _, x, _ = setup
    model = jax_weights.xception_from_jax(params, state)
    fp_tree = tquant.QuantizedXception.from_folded(fold_xception_bn(model, torch.float32))
    xt = torch.from_numpy(x)
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            folded = fold_xception_bn(model, dtype)
            for upto in ("block4", None):
                ref = folded(xt, upto=upto, features_only=True)
                got = tquant.xception_quant_walk(fp_tree, xt, compute_dtype=dtype, upto=upto,
                                                 features_only=True)
                assert torch.equal(got, ref), (dtype, upto)


def test_calibrate_amax_matches_jax(setup):
    _, _, folded, x, amaxes = setup
    fp_tree = jax_weights.quantized_xception_from_jax(folded)
    got = tquant.calibrate_amax(fp_tree, torch.from_numpy(x), compute_dtype=torch.float32)
    assert list(got) == list(tquant._sites(fp_tree, depthwise=True))  # walk order
    assert all(isinstance(tquant._resolve_site(fp_tree, s), tquant.ConvNode) for s in got)
    assert set(got) == set(amaxes)  # (a jitted dict comes back key-sorted)
    for site, ref in amaxes.items():
        np.testing.assert_allclose(got[site], ref, rtol=1e-4, atol=1e-6, err_msg=site)


@pytest.mark.parametrize("act_scales,skip_middle", [("channel", False), ("tensor", False),
                                                    ("channel", True)])
def test_quantize_folded_xception_matches_jax(setup, jax_qtree, act_scales, skip_middle):
    _, _, folded, _, amaxes = setup
    tree = tquant.quantize_folded_xception(
        jax_weights.quantized_xception_from_jax(folded), amaxes, quant_depthwise=True,
        skip_middle=skip_middle, act_scales=act_scales)
    _assert_qtrees_match(jax_weights.quantized_xception_to_jax(tree),
                         jax_qtree(act_scales, skip_middle), rtol=1e-5, fp_exact=True)
    n_k2 = sum(b.k2 for b in tree.blocks)
    n_k1 = sum(b.k1 for b in tree.blocks)
    assert (n_k1, n_k2) == ((8, 0) if skip_middle else (0, 8))


def test_quantize_xception_matches_jax(setup, jax_qtree):
    """fold (the port's, fp32) -> calibrate -> quantize in one call, against
    the JAX package's fold -> calibrate -> quantize; the scales carry the
    calibration's rtol 1e-4."""
    params, state, _, x, _ = setup
    tree = tquant.quantize_xception(jax_weights.xception_from_jax(params, state),
                                    torch.from_numpy(x), compute_dtype=torch.float32,
                                    quant_depthwise=True)
    _assert_qtrees_match(jax_weights.quantized_xception_to_jax(tree), jax_qtree(), rtol=1e-4,
                         fp_exact=False)


def _assert_qtrees_match(got, ref, *, rtol, fp_exact):
    """>= 99.99 % of the int8 codes equal and none off by more than 1; scales
    (and fp weights unless ``fp_exact``) at ``rtol``."""
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(ref)
    codes = equal = 0
    paths = jax.tree_util.tree_flatten_with_path(ref)[0]
    for (path, r), g in zip(paths, jax.tree_util.tree_leaves(got)):
        name = jax.tree_util.keystr(path)
        assert g.shape == r.shape and g.dtype == r.dtype, name
        if r.dtype == np.int8:
            d = np.abs(g.astype(np.int32) - r.astype(np.int32))
            assert d.max() <= 1, name
            codes += d.size
            equal += int((d == 0).sum())
        elif fp_exact and ("'w'" in name or "'b'" in name):  # fp nodes pass through
            np.testing.assert_array_equal(g, r, err_msg=name)
        else:
            np.testing.assert_allclose(g, r, rtol=rtol, atol=1e-7, err_msg=name)
    print(f"int8 codes equal: {equal}/{codes}")
    assert equal / codes >= 0.9999


def test_pack_middle_block_q_undoes_the_channel_fold(jax_qtree):
    """A channel-folded tree (act_scales="channel", quant_depthwise=True):
    K2's operands equal the JAX packer's, incl. the depthwise taps recovered
    through the fold (sepconv_pos.py:275-284)."""
    qtree = jax_qtree()
    tree = jax_weights.quantized_xception_from_jax(qtree)
    blk = tree.blocks[5]
    assert blk.k2 and blk.units[0].depthwise.s_dq is not None
    dw, pw_q, s_w, s_in, s_dq, b = (t.numpy() for t in blk.packed_operands())
    jdw, jpw_q, js_w, js_in, js_dq, jb = map(np.asarray, jax_pack_middle_block_q(qtree["blocks"][5]))
    np.testing.assert_allclose(dw, jdw, rtol=1e-6)
    assert pw_q.shape == (3, 728, 768)  # rows padded to 64 bytes
    np.testing.assert_array_equal(pw_q[..., :728], jpw_q.transpose(0, 2, 1))
    assert not pw_q[..., 728:].any()
    for got, ref in ((s_w, js_w), (s_in, js_in), (s_dq, js_dq), (b, jb)):
        np.testing.assert_allclose(got, ref, rtol=1e-6)


@pytest.mark.parametrize("mode", ["w8a8", "w8a8-hybrid", "w8a8-pallas"])
def test_walk_matches_jax(setup, jax_qtree, mode):
    """One JAX qtree drives both walks; the JAX side takes its interpreted
    fused kernels (K1 on the hybrid's fp middle, K2 otherwise) where the
    mode routes the middle flow through them, the port their plain versions."""
    x = setup[3]
    qtree = jax_qtree(skip_middle=mode == "w8a8-hybrid")
    fused = mode != "w8a8"
    ref = _walk_jax(qtree, x, quant=True, middle_pallas=fused, pallas_interpret=True)
    tree = jax_weights.quantized_xception_from_jax(qtree)
    if fused:
        got = _walk_port(tree, x, quant=True, fuse_middle=True)
    else:  # the unfused w8a8 forward is quantized_xception_apply
        with torch.no_grad():
            got = tquant.quantized_xception_apply(tree, torch.from_numpy(x),
                                                  compute_dtype=torch.float32,
                                                  features_only=True).numpy()
    cos = (got * ref).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(ref, axis=-1))
    err = np.abs(got - ref).max() / np.abs(ref).max()
    print(f"{mode}: per-frame cos min {cos.min():.7f}, max|d|/max|f| {err:.3e}")
    assert cos.min() >= 0.9999
    assert err <= 1e-2


def test_qtree_bridge_roundtrip_exact(jax_qtree):
    """Per-channel ``s_in`` with ``s_dq``, a scalar ``s_in`` without it, and
    the fp middle nodes of a ``skip_middle`` tree."""
    for kw in (dict(), dict(act_scales="tensor"), dict(skip_middle=True)):
        qtree = jax_qtree(**kw)
        back = jax_weights.quantized_xception_to_jax(jax_weights.quantized_xception_from_jax(qtree))
        assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(qtree)
        for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(qtree)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("act_scales", ["tensor", "channel"])
def test_quant_conv_node_keeps_the_weights_device(act_scales):
    """Every tensor of a quantized node lies on its fp weights' device (the
    ``meta`` device stands in for CUDA here), the scalar ``s_in`` of
    ``act_scales="tensor"`` too: the int8 depthwise kernel refuses a CPU
    scale beside CUDA activations."""
    node = tquant.ConvNode(w=torch.ones((8, 1, 3, 3), device="meta"),
                           b=torch.zeros(8, device="meta"))
    q = tquant._quant_conv_node(node, np.linspace(0.5, 2.0, 8, dtype=np.float32), headroom=1.0,
                                act_scales=act_scales, smooth_alpha=0.5, depthwise=True)
    assert {t.device.type for t in q.fields().values()} == {"meta"}, q.fields()


def test_channel_act_scales_preserve_narrow_channels():
    """The port's mirror of tests/test_quant.py::
    test_channel_act_scales_preserve_narrow_channels: a large constant
    carrier channel sets the per-tensor scale and rounds the informative
    channels away; per-channel folding keeps them."""
    rng = np.random.default_rng(0)
    B, C = 8, 8
    x = rng.normal(0, 0.01, (B, 1, 1, C)).astype(np.float32)
    x[:, :, :, 0] = 10.0
    w = rng.normal(0, 0.3, (5, C, 1, 1)).astype(np.float32)
    node = tquant.ConvNode(w=torch.from_numpy(w), b=torch.zeros(5))
    a_vec = np.abs(x).max(axis=(0, 1, 2))
    ref = x.reshape(B, C).astype(np.float64) @ w[:, :, 0, 0].T
    ref_spread = np.abs(ref - ref.mean(0, keepdims=True)).max()
    spread = {}
    for mode in ("tensor", "channel"):
        q = tquant._quant_conv_node(node, a_vec, headroom=1.0, act_scales=mode, smooth_alpha=0.5)
        if mode == "channel":
            assert tuple(q.s_in.shape) == (C,) and q.s_dq.dim() == 0
        y = conv2d_w8a8(torch.from_numpy(x), q.w_q, q.s_w, q.s_in, q.b, q.s_dq,
                        out_dtype=torch.float32).double().numpy().reshape(B, 5)
        spread[mode] = float(np.abs(y - y.mean(0, keepdims=True)).max())
    assert spread["tensor"] == 0.0, spread
    assert spread["channel"] > 0.5 * ref_spread, (spread, ref_spread)
