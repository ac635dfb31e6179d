"""The w8a8 ResNet-18 (the AU models' backbone) against the JAX package,
fp32 on the CPU: the walk in each mode, the calibration, the quantizer, the
int8 forward and the affine refinement, in the scheme of
``tests/test_torch_refine.py``.

The AU-patch tree of ``au_trees.py`` (randomised BN statistics); its
backbone is folded by each package, and the JAX fold is bridged into the
port. Calibration batch: 4 images of 64^2, so the refinement's output site
(the last block's conv2, 2 x 2) sees N = 16 positions per channel.

Bars and CPU readings (max |d|):

- the fp walk against the port's ``FoldedResNet18.forward``: bit-equal (the
  same convolutions); against the JAX walk, every tapped site and the
  features at rtol 1e-3 / atol 2e-4 (readings 8.6e-6 and 3.3e-6);
- the calibrated amaxes, activations of the fp32 walk: the same bar
  (reading 8.6e-6);
- the quantizer on the same amaxes, both ``act_scales``: ``w_q`` equal,
  the scales and biases rtol 1e-6 (readings: ``s_w`` 9.3e-10, ``s_in``
  7.5e-9, ``s_dq`` and ``b`` equal);
- the int8 walk of one JAX tree bridged into the port against JAX's: every
  conv site's output bit-equal (the int32 products are exact, and the
  dequant epilogue, ReLU, pool and residual add are the same fp32
  operations), the 7x7 stem's K of 147 included, which ``_int_gemm`` pads
  to 152; the pooled features rtol 1e-6, the mean's summation order (reading
  2.4e-7);
- the local fits against JAX's: ``||port - jax|| <= 0.05 ||jax - unrefined||``
  per site (reading 0.021 at worst): where an fp32 shadow input sits
  within its summation-order difference of a rounding tie, an int8 code
  flips between the packages;
- the output fit on JAX's locally refined tree against the same fit taken
  eagerly from JAX's walk taps and ``_fit_affine``: atol 1e-6 (reading
  2.3e-7);
- the local fits bring the features closer to the fp32 teacher's, by a
  factor of 0.8 at least (CPU reading: relative error 1.38e-2 -> 9.98e-3).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from multimodal_deepfake_detection_tpu.models import fold as jfold  # noqa: E402
from multimodal_deepfake_detection_tpu.models import quant as jq  # noqa: E402
from multimodal_deepfake_detection_tpu_torch.models import fold as tfold  # noqa: E402
from multimodal_deepfake_detection_tpu_torch.models import quant as tq  # noqa: E402
from multimodal_deepfake_detection_tpu_torch.ops.quant import conv2d_w8a8  # noqa: E402
from multimodal_deepfake_detection_tpu_torch.utils import jax_weights  # noqa: E402

from au_trees import patch_tree  # noqa: E402

FEAT = dict(rtol=1e-3, atol=2e-4)
F32 = jnp.float32
OUTPUT_SITE = "stages/3/1/conv2"


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    """The JAX fold, its amaxes, its w8a8 tree and its locally refined tree
    (``refine_quantized_resnet18(output_sites=())``); the port's fold of the
    same weights and the JAX fold bridged."""
    params, state = patch_tree()
    x = np.random.default_rng(11).uniform(0, 1, (4, 64, 64, 3)).astype(np.float32)
    folded = _np(jfold.fold_resnet18_bn(params["backbone"], state["backbone"]))
    amaxes = jq.calibrate_resnet18_amax(folded, jnp.asarray(x), compute_dtype=F32)
    q0 = _np(jq.quantize_folded_resnet18(folded, amaxes))
    local = _np(jq.refine_quantized_resnet18(q0, folded, jnp.asarray(x), passes=1,
                                             output_sites=(), compute_dtype=F32))
    port = jax_weights.au_patch_from_jax(params, state)
    return dict(x=x, folded=folded, amaxes=amaxes, q0=q0, local=local,
                port_fold=tfold.fold_resnet18_bn(port.backbone),
                fp_tree=jax_weights.quantized_resnet18_from_jax(folded))


def _walk(tree, x, **kw):
    with torch.no_grad():
        return tq.resnet18_quant_walk(tree, torch.from_numpy(x), compute_dtype=torch.float32,
                                      **kw)


def test_fp_walk_is_the_folded_forward_and_matches_jax(setup):
    """The fp walk over the port's own fold is its ``FoldedResNet18`` forward,
    bit for bit; every tapped site (before its ReLU), in walk order, and the
    features match the JAX walk's."""
    x = setup["x"]
    own = tq.QuantizedResNet18.from_folded(setup["port_fold"])
    with torch.no_grad():
        torch.testing.assert_close(_walk(own, x), setup["port_fold"](torch.from_numpy(x)),
                                   rtol=0, atol=0)
    got, ref = {}, {}
    feats = _walk(own, x, tap=lambda s, y: got.__setitem__(s, y.numpy()))
    ref_feats = jq.resnet18_quant_walk(setup["folded"], jnp.asarray(x), compute_dtype=F32,
                                       tap=lambda s, y: ref.__setitem__(s, np.asarray(y)))
    assert list(got) == list(ref) == list(tq._resnet18_sites(own))
    assert len(got) == 20 and got["conv1"].min() < 0
    for site in got:
        np.testing.assert_allclose(got[site], ref[site], err_msg=site, **FEAT)
    np.testing.assert_allclose(feats.numpy(), np.asarray(ref_feats), **FEAT)


def test_calibration_matches_jax(setup):
    got = tq.calibrate_resnet18_amax(setup["fp_tree"], torch.from_numpy(setup["x"]),
                                     compute_dtype=torch.float32)
    ref = setup["amaxes"]
    assert list(got) == list(ref)
    assert got["conv1"].shape == (3,) and got["stages/3/1/conv2"].shape == (512,)
    for site in got:
        np.testing.assert_allclose(got[site], ref[site], err_msg=site, **FEAT)


@pytest.mark.parametrize("act_scales", ["channel", "tensor"])
def test_quantizer_matches_jax(setup, act_scales):
    """The same fp tree and amaxes -> the same int8 tree."""
    ref = jq.quantize_folded_resnet18(setup["folded"], setup["amaxes"], act_scales=act_scales)
    got = tq.quantize_folded_resnet18(setup["fp_tree"], setup["amaxes"], act_scales=act_scales)
    ref = jax_weights.quantized_resnet18_from_jax(_np(ref))
    sites = list(tq._resnet18_sites(got))
    for site in sites:
        a, b = tq._resolve_site(got, site), tq._resolve_site(ref, site)
        assert a.quantized and sorted(a.fields()) == sorted(b.fields()), site
        assert torch.equal(a.w_q, b.w_q), site
        for k in ("s_w", "s_in", "s_dq", "b"):
            if getattr(b, k) is not None:
                torch.testing.assert_close(getattr(a, k), getattr(b, k), rtol=1e-6, atol=0)
    with pytest.raises(ValueError, match="missing site"):
        tq.quantize_folded_resnet18(setup["fp_tree"], {"conv1": setup["amaxes"]["conv1"]})


def test_int8_walk_matches_jax(setup):
    """One JAX w8a8 tree in both walks: every conv site's output bit-equal,
    the pooled features within an ulp (the mean's summation order). The
    stem is int8 too, an im2col of K = 7 * 7 * 3 = 147."""
    q0 = jax_weights.quantized_resnet18_from_jax(setup["q0"])
    assert tuple(q0.conv1.w_q.shape) == (64, 3, 7, 7) and q0.conv1.w_q.dtype == torch.int8
    got_taps, ref_taps = {}, {}
    got = _walk(q0, setup["x"], quant=True, tap=lambda s, y: got_taps.__setitem__(s, y.numpy()))
    ref = jq.resnet18_quant_walk(setup["q0"], jnp.asarray(setup["x"]), quant=True,
                                 compute_dtype=F32,
                                 tap=lambda s, y: ref_taps.__setitem__(s, np.asarray(y)))
    assert list(got_taps) == list(ref_taps)
    for site in got_taps:
        np.testing.assert_array_equal(got_taps[site], ref_taps[site], err_msg=site)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=0)
    fp = _walk(setup["fp_tree"], setup["x"])
    assert 0 < (got - fp).abs().max() < 0.05 * fp.abs().max()


def test_bridge_round_trips_the_quantized_tree(setup):
    back = jax_weights.quantized_resnet18_to_jax(jax_weights.quantized_resnet18_from_jax(
        setup["q0"]))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(setup["q0"])
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(setup["q0"])):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_shadow_applies_the_int8_node_to_the_same_input(setup):
    q0 = jax_weights.quantized_resnet18_from_jax(setup["q0"])
    pairs = {}
    _walk(setup["fp_tree"], setup["x"], tap=lambda s, yf, yq: pairs.__setitem__(s, (yf, yq)),
          shadow=q0)
    assert list(pairs) == list(tq._resnet18_sites(q0))
    n = q0.conv1
    ref = conv2d_w8a8(torch.from_numpy(setup["x"]), n.w_q, n.s_w, n.s_in, n.b, n.s_dq, stride=2,
                      padding=3, out_dtype=torch.float32)
    torch.testing.assert_close(pairs["conv1"][1], ref, rtol=0, atol=0)
    with pytest.raises(ValueError, match="shadow"):
        _walk(setup["fp_tree"], setup["x"], shadow=q0)


def test_local_fits_match_jax(setup):
    """The port's local fits of the JAX tree against the JAX package's, at
    every site but the output one (bound: module docstring)."""
    q0, jax_local = (jax_weights.quantized_resnet18_from_jax(setup[k]) for k in ("q0", "local"))
    with torch.no_grad():
        got = tq.refine_quantized_resnet18(q0, setup["fp_tree"], torch.from_numpy(setup["x"]),
                                           passes=1, output_sites=())
    sites = list(tq._resnet18_sites(q0))
    assert len(sites) == 20
    for site in sites:
        a, b, c = (tq._resolve_site(t, site) for t in (got, jax_local, q0))
        for k in ("s_w", "b"):
            step = (getattr(b, k) - getattr(c, k)).norm()
            assert step > 0, site
            assert (getattr(a, k) - getattr(b, k)).norm() <= 0.05 * step, (site, k)
        assert torch.equal(a.w_q, c.w_q)
    assert torch.equal(q0.conv1.s_w, jax_weights.quantized_resnet18_from_jax(
        setup["q0"]).conv1.s_w)  # the input tree is left as it was


def _jax_output_fit(local, folded, x):
    """JAX's output touch-up at the last block's conv2, evaluated eagerly on
    its locally refined tree: the fit of the q-walk's tap on the fp walk's,
    shrunk by N / (N + 64)."""
    teacher, taps = {}, {}
    jq.resnet18_quant_walk(folded, x, compute_dtype=F32,
                           tap=lambda s, y: teacher.__setitem__(s, y))
    jq.resnet18_quant_walk(local, x, quant=True, compute_dtype=F32,
                           tap=lambda s, y: taps.__setitem__(s, y))
    q, f = taps[OUTPUT_SITE], teacher[OUTPUT_SITE]
    ax = (0, 1, 2)
    qm, fm = q.mean(ax), f.mean(ax)
    mom = (((q - qm) ** 2).mean(ax), ((q - qm) * (f - fm)).mean(ax), qm, fm, (q * q).mean(ax),
           (q * f).mean(ax))
    n = int(np.prod(q.shape[:-1]))
    assert n == 16
    node = jq._fit_affine(mom, jq._resolve_site(local, OUTPUT_SITE), shrink=n / (n + 64.0))
    tree = jax.tree_util.tree_map(lambda a: a, local)
    tree["stages"][3][1]["conv2"] = _np(node)
    return tree


def test_output_fit_matches_jax(setup):
    ref = jax_weights.quantized_resnet18_from_jax(
        _jax_output_fit(setup["local"], setup["folded"], jnp.asarray(setup["x"])))
    local = jax_weights.quantized_resnet18_from_jax(setup["local"])
    with torch.no_grad():
        got = tq.refine_quantized_resnet18(local, setup["fp_tree"],
                                           torch.from_numpy(setup["x"]), passes=0)
    a, b, c = (tq._resolve_site(t, OUTPUT_SITE) for t in (got, ref, local))
    assert not torch.equal(b.b, c.b)
    for k in ("s_w", "b"):
        torch.testing.assert_close(getattr(a, k), getattr(b, k), rtol=0, atol=1e-6)


def test_local_fits_reduce_the_int8_error(setup):
    q0 = jax_weights.quantized_resnet18_from_jax(setup["q0"])
    with torch.no_grad():
        qr = tq.refine_quantized_resnet18(q0, setup["fp_tree"], torch.from_numpy(setup["x"]),
                                          passes=1, output_sites=())
    fp = _walk(setup["fp_tree"], setup["x"]).double()
    err = lambda t: ((_walk(t, setup["x"], quant=True).double() - fp).norm() / fp.norm()).item()
    assert err(qr) < 0.8 * err(q0), (err(q0), err(qr))
