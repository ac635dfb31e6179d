"""The audio engine's backbone on each kernel route against the JAX
package, fp32 on the CPU, at the audio path's shapes.

The input is the MFCC images of one 800-sample waveform: 6 images of 64^2,
each constant along W, with values in the hundreds (dB-scaled units, not
[0, 1]). The backbone's stages there: stem 31^2 -> 29^2, stride-2 blocks at
29^2, 15^2, 8^2 and 4^2, a 4 x 4 middle flow, a 2 x 2 exit. On a CPU tensor
``use_kernels=True`` runs each kernel's plain version; the JAX side runs
the JAX package's own kernel for the route in interpret mode, as
tests/test_torch_routes.py and tests/test_torch_entry_block.py do at 64^2
(their helpers are reused). Both sides round at the same points. Bound:
features rtol 1e-4 / atol 2e-5, the routes' 64^2 bar; CPU readings max|d|
8.9e-8 (K1, bf16 taps), 1.2e-7 (entry_pair) and 1.2e-6 (fuse_entry) at
features up to 0.50. fuse_exit: atol 1e-4. Its kernel rounds the exit's
depthwise output to bf16 before the pointwise, and the two sides' fp32
inputs to that rounding differ in summation order (the CPU's convolutions
sum NHWC images in another order than NCHW ones), so a few activations
land one bf16 ulp apart (2^-8 relative) and move a 2 x 2-averaged feature
by up to ~1e-4: readings 1.4e-5 (images channels-first in memory) and
3.4e-5 at 5 of 12,288 features (NHWC-contiguous, as served).
``AudioScorer`` with each route is held against the JAX ``AudioScorer``'s
scores (``use_pallas=False``), atol 1e-4.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from multimodal_deepfake_detection_tpu.models import serve as jserve  # noqa: E402
from multimodal_deepfake_detection_tpu.models.fold import (  # noqa: E402
    fold_xception_bn as jax_fold_xception_bn,
)
from multimodal_deepfake_detection_tpu.models.fold import folded_xception_apply  # noqa: E402
from multimodal_deepfake_detection_tpu.models.heads import xception_lstm_init  # noqa: E402
from multimodal_deepfake_detection_tpu.ops.conv import global_avg_pool  # noqa: E402
from multimodal_deepfake_detection_tpu.ops.pallas import sepconv_block  # noqa: E402
from multimodal_deepfake_detection_tpu.ops.pallas.sepconv_unit import (  # noqa: E402
    pack_unit as jax_pack_unit,
)
from multimodal_deepfake_detection_tpu.ops.pallas.sepconv_unit import (  # noqa: E402
    sepconv_unit_pallas,
)
from multimodal_deepfake_detection_tpu_torch.models.serve import AudioScorer  # noqa: E402
from multimodal_deepfake_detection_tpu_torch.utils import jax_weights  # noqa: E402

from test_torch_routes import _jax_entry_pair_route, _port, _randomize_bn  # noqa: E402

HIDDEN = 8
ROUTES = {"K1": {}, "middle_taps": dict(middle_taps="bf16"), "entry_pair": dict(entry_pair=True),
          "fuse_exit": dict(fuse_exit=True), "fuse_entry": dict(fuse_entry=True)}
KERNEL = {"K1": "middle_block", "middle_taps": "middle_block", "entry_pair": "_entry_pair",
          "fuse_exit": "sepconv_unit", "fuse_entry": "entry_block"}


@pytest.fixture(scope="module")
def setup():
    """The trees, the JAX fold, the port's fp32 fold and the MFCC images of
    one 800-sample waveform."""
    params, state = xception_lstm_init(jax.random.PRNGKey(11), HIDDEN)
    params = jax.tree_util.tree_map(np.asarray, params)
    state = jax.tree_util.tree_map(np.asarray, state)
    _randomize_bn(params["backbone"], state["backbone"], np.random.default_rng(11))
    waves = np.random.default_rng(11).normal(0, 0.1, (1, 800)).astype(np.float32)
    sc = AudioScorer(jax_weights.xception_lstm_from_jax(params, state),
                     compute_dtype=torch.float32, device="cpu")
    with torch.no_grad():
        x = sc._wave_to_imgs(waves, centered=True)[0].numpy()
    assert x.shape == (6, 64, 64, 3) and np.abs(x).max() > 100
    np.testing.assert_allclose(x, np.broadcast_to(x[:, :, :1], x.shape), rtol=1e-6)  # in W
    jfold = jax_fold_xception_bn(params["backbone"], state["backbone"])
    return dict(params=params, state=state, x=x, jfold=jfold, tf=sc.folded_backbone)


def _jax_route(route, jfold, x, monkeypatch):
    """The JAX forward that runs the JAX package's kernel for ``route``."""
    monkeypatch.delenv("MDFD_MIDDLE_LAYOUT", raising=False)
    monkeypatch.delenv("MDFD_ENTRY_FUSE_H", raising=False)
    if route == "entry_pair":
        return _jax_entry_pair_route(jfold, x)
    if route == "fuse_exit":
        h = folded_xception_apply(jfold, x, use_pallas=True, pallas_interpret=True,
                                  upto="block12")
        for conv in ("conv3", "conv4"):
            dw, pw, b = jax_pack_unit(jfold[conv])
            h = sepconv_unit_pallas(h, dw, pw.astype(jnp.bfloat16).astype(jnp.float32), b,
                                    leading_relu=False, trailing_relu=True, interpret=True)
        return global_avg_pool(h)
    if route == "middle_taps":
        monkeypatch.setenv("MDFD_MIDDLE_LAYOUT", "hw")
        v2 = sepconv_block.middle_block_pallas_v2
        monkeypatch.setattr(sepconv_block, "middle_block_pallas_v2",
                            lambda *a, **k: v2(*a, **dict(k, precise=False)))
    if route == "fuse_entry":
        monkeypatch.setenv("MDFD_ENTRY_FUSE_H", "29,15,8,4")
    return folded_xception_apply(jfold, x, features_only=True, use_pallas=True,
                                 pallas_interpret=True)


@pytest.mark.parametrize("route", list(ROUTES))
def test_audio_backbone_route_matches_jax(setup, route, monkeypatch):
    ref = np.asarray(_jax_route(route, setup["jfold"], jnp.asarray(setup["x"]), monkeypatch))
    got, calls = _port(setup["tf"], setup["x"], monkeypatch, KERNEL[route], **ROUTES[route])
    assert len(calls) == {"middle_block": 8, "_entry_pair": 4, "sepconv_unit": 2,
                          "entry_block": 4}[KERNEL[route]]
    if route == "middle_taps":
        assert [k["taps"] for k in calls] == ["bf16"] * 8
    print(f"{route}: features max|d|={np.abs(got - ref).max():.3e} "
          f"(max|ref|={np.abs(ref).max():.3e})")
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 if route == "fuse_exit" else 2e-5)


@pytest.fixture(scope="module")
def jax_scores(setup):
    waves = np.random.default_rng(12).normal(0, 0.1, (2, 1733)).astype(np.float32)
    jsc = jserve.AudioScorer(setup["params"], setup["state"], compute_dtype=jnp.float32,
                             use_pallas=False)
    return waves, jsc.score(waves)


@pytest.mark.parametrize("route", list(ROUTES))
def test_audio_scorer_route_matches_jax_scores(setup, jax_scores, route):
    waves, ref = jax_scores
    scorer = AudioScorer(jax_weights.xception_lstm_from_jax(setup["params"], setup["state"]),
                         compute_dtype=torch.float32, use_kernels=True, device="cpu",
                         **ROUTES[route])
    got = scorer.score(waves)
    print(f"{route}: score max|d|={np.abs(got - ref).max():.3e}")
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_audio_route_with_quantize_raises(setup):
    model = jax_weights.xception_lstm_from_jax(setup["params"], setup["state"])
    for route, quantize in (("middle_taps", "w8a8-pallas"), ("fuse_entry", "w8a8")):
        with pytest.raises(ValueError, match=route):
            AudioScorer(model, quantize=quantize, device="cpu", **ROUTES[route])
    with pytest.raises(ValueError, match="fuse_entry"):
        AudioScorer(model, entry_pair=True, fuse_entry=True, device="cpu")
