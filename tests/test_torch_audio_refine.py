"""The audio engine's refined w8a8 calibration against the JAX package,
fp32 on the CPU.

One JAX-initialised XceptionLSTMA (hidden 8, randomised BN statistics);
one waveform of 1,200 samples, 8 MFCC images of 64^2, calibrates and is
scored, in the ``w8a8`` mode. The JAX-refined tree is built as
tests/test_torch_refine.py builds it, for the reasons given there: the JAX
package's local fits, then its output fits taken eagerly (the exit's 32
positions per channel make those fits ill-conditioned). Bounds: the tree
bridged into the port's scorer, atol 1e-5 (the int8 forwards agree to the
bit); the port's own ``calibrate(refine_passes=1)``, atol 1e-3 (the local
fits see int8 codes flip at rounding ties between the packages).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from multimodal_deepfake_detection_tpu.models import quant as jq  # noqa: E402
from multimodal_deepfake_detection_tpu.models import serve as jserve  # noqa: E402
from multimodal_deepfake_detection_tpu.models.heads import xception_lstm_init  # noqa: E402
from multimodal_deepfake_detection_tpu_torch.models.serve import AudioScorer  # noqa: E402
from multimodal_deepfake_detection_tpu_torch.utils import jax_weights  # noqa: E402

from test_torch_refine import _jax_output_fits, _np_tree  # noqa: E402
from test_torch_serve import _randomize_bn  # noqa: E402


def test_audio_scorer_refined_calibration_matches_jax():
    params, state = xception_lstm_init(jax.random.PRNGKey(14), 8)
    params, state = _np_tree(params), _np_tree(state)
    _randomize_bn(params["backbone"], state["backbone"], np.random.default_rng(14))
    waves = np.random.default_rng(14).normal(0, 0.1, (1, 1200)).astype(np.float32)
    jsc = jserve.AudioScorer(params, state, compute_dtype=jnp.float32, use_pallas=False,
                             quantize="w8a8")
    jsc.calibrate(waves)
    q0 = _np_tree(jsc._qbackbone)
    imgs = jsc._wave_to_imgs(jnp.asarray(waves), True)[0]
    local = _np_tree(jq.refine_quantized_xception(q0, jsc.folded_backbone, imgs, passes=1,
                                                  output_sites=(), compute_dtype=jnp.float32))
    full = _jax_output_fits(local, jsc.folded_backbone, imgs, n_expected=32)
    jsc._qbackbone = jax.device_put(full)
    ref = jsc.score(waves)

    tsc = AudioScorer(jax_weights.xception_lstm_from_jax(params, state),
                      compute_dtype=torch.float32, device="cpu", quantize="w8a8")
    tsc.calibrate(waves, refine_passes=1)
    unrefined = jax_weights.quantized_xception_from_jax(q0)
    assert not torch.equal(tsc.qbackbone.conv1.s_w, unrefined.conv1.s_w)
    np.testing.assert_allclose(tsc.score(waves), ref, rtol=0, atol=1e-3)
    tsc.qbackbone = jax_weights.quantized_xception_from_jax(full)
    np.testing.assert_allclose(tsc.score(waves), ref, rtol=0, atol=1e-5)
