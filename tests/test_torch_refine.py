"""The walk's tap/shadow hooks and the w8a8 affine refinement against the
JAX package, fp32 on the CPU.

One JAX-initialised XceptionLSTMV with randomised BN statistics and an
ArcFace head (hidden 8); the calibration batch is one clip of two 64^2
frames. Each side's w8a8 trees run their int8 convs exactly, so a tree
bridged from JAX forwards bit-equal in the port; the fp32 teacher differs
by summation order only (~1e-7). The refinement is a least-squares fit of
the teacher's outputs on the int8 outputs, and two things make it more
sensitive than the forwards it fits:

- the **local fits** apply each int8 node to the teacher's own input:
  where that fp32 input sits within its summation-order difference of a
  rounding tie, the int8 code flips between the packages. Held per site as
  ``||port - jax|| <= 0.05 ||jax - unrefined||`` (CPU reading: 0.024 at
  worst): a wrong fit would move by the whole correction.
- the **output fits** at conv3/conv4's pointwise see N = 8 positions per
  channel (2 images of 2 x 2), and their moments are ill-conditioned: the
  JAX package's own jitted and eager evaluations of the same fit differ by
  3.6e-4 in ``b``. So the reference output fits are taken here eagerly,
  from JAX's walk taps and JAX's ``_fit_affine``, on the tree of JAX's
  local fits (``refine_quantized_xception(output_sites=())``), and the
  port's output fits on that same tree are held to them at atol 1e-6
  (reading 9e-8). That reference, the JAX local fits and then its output
  fits, is the JAX-refined tree below.

Scores: the JAX-refined tree bridged into the port's scorer against the
JAX scorer holding it, atol 1e-5 (the int8 forwards agree to the bit); the
port's own ``calibrate(refine_passes=1)`` against it, atol 1e-3 (the bar of
the w8a8 scorer tests: the trees differ by the code flips above).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from multimodal_deepfake_detection_tpu.models import quant as jq  # noqa: E402
from multimodal_deepfake_detection_tpu.models import serve as jserve  # noqa: E402
from multimodal_deepfake_detection_tpu.models.heads import (  # noqa: E402
    arcface_init,
    xception_lstm_init,
)
from multimodal_deepfake_detection_tpu_torch.models import quant as tq  # noqa: E402
from multimodal_deepfake_detection_tpu_torch.models.serve import VisualScorer  # noqa: E402
from multimodal_deepfake_detection_tpu_torch.ops.quant import conv2d_w8a8  # noqa: E402
from multimodal_deepfake_detection_tpu_torch.utils import jax_weights  # noqa: E402

from test_torch_serve import _randomize_bn  # noqa: E402

HIDDEN = 8
OUTPUT_SITES = ("conv3/pointwise", "conv4/pointwise")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_output_fits(local, fp, x, n_expected=8):
    """The JAX package's output touch-up (``_refine_tree``'s last loop),
    evaluated eagerly, on its locally refined tree ``local``: sequential
    fits with ``N / (N + 64)`` shrinkage (``n_expected`` positions per
    channel), each re-measured."""
    tree, teacher = dict(local), {}
    jq.xception_quant_walk(fp, x, quant=False, compute_dtype=jnp.float32, features_only=True,
                           tap=lambda s, y: teacher.__setitem__(s, y))
    for site in OUTPUT_SITES:
        taps = {}
        jq.xception_quant_walk(tree, x, quant=True, compute_dtype=jnp.float32,
                               features_only=True, tap=lambda s, y: taps.__setitem__(s, y))
        q, f = taps[site], teacher[site]
        ax = (0, 1, 2)
        qm, fm = q.mean(ax), f.mean(ax)
        mom = (((q - qm) ** 2).mean(ax), ((q - qm) * (f - fm)).mean(ax), qm, fm,
               (q * q).mean(ax), (q * f).mean(ax))
        n = int(np.prod(q.shape[:-1]))
        assert n == n_expected
        node = jq._fit_affine(mom, jq._resolve_site(tree, site), shrink=n / (n + 64.0))
        parent, _, name = site.rpartition("/")
        tree[parent] = dict(tree[parent], **{name: _np_tree(node)})
    return tree


@pytest.fixture(scope="module")
def setup():
    """Both scorers (w8a8), the frames, the JAX qtree calibrated on them,
    the JAX package's locally refined tree (``refine_quantized_xception``
    without output sites) and that tree with the output fits."""
    params, state = xception_lstm_init(jax.random.PRNGKey(7), HIDDEN)
    params, state = _np_tree(params), _np_tree(state)
    _randomize_bn(params["backbone"], state["backbone"], np.random.default_rng(7))
    arc = _np_tree(arcface_init(jax.random.PRNGKey(8), HIDDEN, 2))
    frames = np.random.default_rng(7).integers(0, 255, (1, 2, 64, 64, 3), np.uint8)
    jsc = jserve.VisualScorer(dict(params, arcface=arc), state, compute_dtype=jnp.float32,
                              use_pallas=False, quantize="w8a8")
    jsc.calibrate(frames)
    q0 = _np_tree(jsc._qbackbone)
    x = jsc._frames_to_x(frames)
    local = _np_tree(jq.refine_quantized_xception(q0, jsc.folded_backbone, x, passes=1,
                                                  output_sites=(), compute_dtype=jnp.float32))
    tsc = VisualScorer(jax_weights.xception_lstm_from_jax(params, state),
                       jax_weights.arcface_from_jax(arc), compute_dtype=torch.float32,
                       device="cpu", quantize="w8a8")
    return dict(jsc=jsc, tsc=tsc, frames=frames, x=np.asarray(x), q0=q0, local=local,
                full=_jax_output_fits(local, jsc.folded_backbone, x))


def _walk(tree, x, **kw):
    with torch.no_grad():
        return tq.xception_quant_walk(tree, torch.from_numpy(x), compute_dtype=torch.float32,
                                      features_only=True, use_kernels=False, **kw)


def test_tap_reports_every_site_as_jax(setup):
    """``tap`` sees every conv site in walk order, each output before its
    ReLU (conv1's goes negative), equal to the JAX walk's at the feature
    bar (rtol 1e-3 / atol 2e-4)."""
    tsc, x = setup["tsc"], setup["x"]
    got, ref = {}, {}
    _walk(tsc.fp_tree, x, tap=lambda s, y: got.__setitem__(s, y.numpy()))
    jq.xception_quant_walk(setup["jsc"].folded_backbone, jnp.asarray(x), quant=False,
                           compute_dtype=jnp.float32, features_only=True,
                           tap=lambda s, y: ref.__setitem__(s, np.asarray(y)))
    assert list(got) == list(ref) == list(tq._sites(tsc.fp_tree, depthwise=True))
    assert got["conv1"].min() < 0
    for site in got:
        np.testing.assert_allclose(got[site], ref[site], rtol=1e-3, atol=2e-4, err_msg=site)


def test_shadow_applies_the_int8_node_to_the_same_input(setup):
    """With ``shadow``, each site's int8 node sees the fp walk's input:
    at conv1 that is x itself, so the shadow output is the int8 conv of x."""
    tsc, x = setup["tsc"], setup["x"]
    q0 = jax_weights.quantized_xception_from_jax(setup["q0"])
    pairs = {}
    _walk(tsc.fp_tree, x, tap=lambda s, yf, yq: pairs.__setitem__(s, (yf, yq)), shadow=q0)
    assert list(pairs) == list(tq._sites(tsc.fp_tree, depthwise=True))
    yf, yq = pairs["conv1"]
    n = q0.conv1
    ref = conv2d_w8a8(torch.from_numpy(x), n.w_q, n.s_w, n.s_in, n.b, n.s_dq, stride=2,
                      padding=0, out_dtype=torch.float32)
    torch.testing.assert_close(yq, ref, rtol=0, atol=0)
    assert not torch.allclose(yf, yq)


def test_walk_hooks_refusals(setup):
    tsc, x = setup["tsc"], setup["x"]
    with pytest.raises(ValueError, match="shadow"):
        _walk(tsc.fp_tree, x, shadow=tsc.fp_tree)
    with pytest.raises(ValueError, match="tap"):
        _walk(tsc.fp_tree, x, fuse_middle=True, tap=lambda s, y: None)


@pytest.mark.parametrize("bias,shrink", [(True, 1.0), (True, 0.3), (False, 1.0), (False, 0.3)])
def test_fit_affine_matches_jax(bias, shrink):
    """The fit alone, on the same moments (a zero variance and a gain past
    the clip among them): rtol 1e-6."""
    rng = np.random.default_rng(int(bias) * 10 + int(shrink * 10))
    C = 16
    mom = [np.abs(rng.normal(size=C)).astype(np.float32) for _ in range(6)]
    mom[0][0] = mom[4][0] = 0.0
    mom[1][1] = 5 * mom[0][1]
    node = dict(w_q=rng.integers(-127, 128, (1, 1, 8, C)).astype(np.int8),
                s_w=np.abs(rng.normal(size=C)).astype(np.float32) * 1e-2,
                s_in=np.float32(0.02))
    if bias:
        node["b"] = rng.normal(size=C).astype(np.float32)
    ref = jq._fit_affine(mom, node, shrink=shrink)
    got = tq._fit_affine([torch.from_numpy(m) for m in mom],
                         jax_weights._node_from_jax(node), shrink=shrink)
    for k in ("s_w", "b") if bias else ("s_w",):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(ref[k]), rtol=1e-6,
                                   atol=0, err_msg=k)
    assert (got.b is None) == (not bias)


def _quant_sites(tree):
    return [s for s in tq._sites(tree, depthwise=True) if tq._resolve_site(tree, s).quantized]


def test_local_fits_match_jax(setup):
    """The port's refinement of the JAX qtree against the JAX package's, at
    every site the output fits leave alone (bound: module docstring)."""
    tsc, x = setup["tsc"], setup["x"]
    q0, jax_local = (jax_weights.quantized_xception_from_jax(setup[k]) for k in ("q0", "local"))
    with torch.no_grad():
        got = tq.refine_quantized_xception(q0, tsc.fp_tree, torch.from_numpy(x), passes=1)
    sites = [s for s in _quant_sites(q0) if s not in OUTPUT_SITES]
    assert len(sites) == 72
    for site in sites:
        a, b, c = (tq._resolve_site(t, site) for t in (got, jax_local, q0))
        for k in ("s_w", "b"):
            if getattr(c, k) is None:
                continue
            step = (getattr(b, k) - getattr(c, k)).norm()
            assert step > 0, site
            assert (getattr(a, k) - getattr(b, k)).norm() <= 0.05 * step, (site, k)
            torch.testing.assert_close(getattr(a, k), getattr(b, k), rtol=1e-2, atol=1e-4)
    # the input tree is left as it was; the int8 weights never move
    unchanged = jax_weights.quantized_xception_from_jax(setup["q0"])
    for site in sites:
        for k in ("w_q", "s_w"):
            assert torch.equal(getattr(tq._resolve_site(q0, site), k),
                               getattr(tq._resolve_site(unchanged, site), k))
        assert torch.equal(tq._resolve_site(got, site).w_q, tq._resolve_site(q0, site).w_q)


def test_output_fits_match_jax(setup):
    """The output touch-up on the JAX package's locally refined tree: the
    port against the same fits taken eagerly from JAX's walk and
    ``_fit_affine`` (bound: module docstring)."""
    tsc, x = setup["tsc"], setup["x"]
    ref, local = (jax_weights.quantized_xception_from_jax(setup[k]) for k in ("full", "local"))
    with torch.no_grad():
        got = tq.refine_quantized_xception(local, tsc.fp_tree, torch.from_numpy(x), passes=0)
    for site in OUTPUT_SITES:
        a, b, c = (tq._resolve_site(t, site) for t in (got, ref, local))
        assert not torch.equal(b.b, c.b)
        for k in ("s_w", "b"):
            torch.testing.assert_close(getattr(a, k), getattr(b, k), rtol=0, atol=1e-6)


def test_local_fits_reduce_the_int8_error(setup):
    """On the calibration batch the tree of local fits has features closer
    to the fp32 teacher's than the tree it came from (CPU reading: relative
    error 1.73e-4 -> 1.04e-4; the output fits then overfit this batch's 8
    exit positions per channel, 8.9e-4, the JAX package's refined tree as
    the port's), and K2's packed operands follow the refined nodes."""
    tsc, x = setup["tsc"], setup["x"]
    q0 = jax_weights.quantized_xception_from_jax(setup["q0"])
    with torch.no_grad():
        qr = tq.refine_quantized_xception(q0, tsc.fp_tree, torch.from_numpy(x), passes=1,
                                          output_sites=())
    fp = _walk(tsc.fp_tree, x).double()
    err = lambda t: ((_walk(t, x, quant=True).double() - fp).norm() / fp.norm()).item()
    assert err(qr) < 0.8 * err(q0), (err(q0), err(qr))
    for blk0, blk1 in zip(q0.blocks, qr.blocks):
        assert blk1.k2 == blk0.k2
        if blk1.k2:
            assert all(torch.equal(a, b) for a, b in zip(blk1.packed_operands(),
                                                          tq.pack_middle_block_q(blk1.units)))
            assert not torch.equal(blk1.packed_operands()[2], blk0.packed_operands()[2])  # s_w


def test_visual_scorer_refined_calibration_matches_jax(setup):
    """``calibrate(refine_passes=1)``: the port's own against the JAX
    scorer's (atol 1e-3), and the JAX-refined tree in the port's scorer
    against the JAX scorer holding it (atol 1e-5)."""
    jsc, tsc, frames = setup["jsc"], setup["tsc"], setup["frames"]
    jsc._qbackbone = jax.device_put(setup["full"])
    ref = jsc.score(frames)
    tsc.calibrate(frames, refine_passes=1)
    got = tsc.score(frames)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)
    tsc.qbackbone = jax_weights.quantized_xception_from_jax(setup["full"])
    np.testing.assert_allclose(tsc.score(frames), ref, rtol=0, atol=1e-5)
