"""The port's w8a8 audio engine against the JAX package, fp32 on the CPU.

One JAX-initialised XceptionLSTMA (hidden 8, randomised BN statistics) and
one waveform of 1,200 samples (8 MFCC images of 64^2, values in the
hundreds) for calibration and scoring. The JAX ``AudioScorer`` runs its
fused kernels interpreted, the port's CPU scorer their plain versions.
The int8 convs are exact on both sides, so a qtree bridged from JAX scores
as JAX's does up to K2's epilogue, which XLA on the CPU contracts into an
FMA (<= 2 ulps; tests/test_torch_middle_block_w8.py): atol 1e-5. Each
side's own calibration differs by the fp32 teacher's summation order, which
can flip an int8 code at a rounding tie: atol 1e-3, the bar of the visual
w8a8 tests. The refined calibration of the audio engine is in
tests/test_torch_audio_refine.py.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from multimodal_deepfake_detection_tpu.models import serve as jserve  # noqa: E402
from multimodal_deepfake_detection_tpu.models.heads import xception_lstm_init  # noqa: E402
from multimodal_deepfake_detection_tpu_torch.models.serve import AudioScorer  # noqa: E402
from multimodal_deepfake_detection_tpu_torch.utils import jax_weights  # noqa: E402

from test_torch_refine import _np_tree  # noqa: E402
from test_torch_serve import _randomize_bn  # noqa: E402

HIDDEN = 8


@pytest.fixture(scope="module")
def setup():
    params, state = xception_lstm_init(jax.random.PRNGKey(13), HIDDEN)
    params, state = _np_tree(params), _np_tree(state)
    _randomize_bn(params["backbone"], state["backbone"], np.random.default_rng(13))
    waves = np.random.default_rng(13).normal(0, 0.1, (1, 1200)).astype(np.float32)
    jsc = jserve.AudioScorer(params, state, compute_dtype=jnp.float32, use_pallas=False,
                             quantize="w8a8-pallas")
    ref = jsc.score(waves)  # calibrates on its first batch
    return dict(params=params, state=state, waves=waves, jsc=jsc, ref=ref,
                q0=_np_tree(jsc._qbackbone))


def _port(setup, **kw):
    return AudioScorer(jax_weights.xception_lstm_from_jax(setup["params"], setup["state"]),
                       compute_dtype=torch.float32, device="cpu", quantize="w8a8-pallas", **kw)


def test_w8a8_pallas_audio_scorer_matches_jax(setup):
    """Calibrated by each side on the first batch, then with JAX's qtree
    bridged in; the middle flow runs K2's plain version (8 blocks)."""
    tsc = _port(setup)
    got = tsc.score(setup["waves"])
    assert sum(b.k2 for b in tsc.qbackbone.blocks) == 8
    np.testing.assert_allclose(got, setup["ref"], rtol=0, atol=1e-3)
    tsc.qbackbone = jax_weights.quantized_xception_from_jax(setup["q0"])
    np.testing.assert_allclose(tsc.score(setup["waves"]), setup["ref"], rtol=0, atol=1e-5)


def test_audio_calibration_runs_on_centred_mfcc_images(setup, monkeypatch):
    """``calibrate`` fits on the centred MFCC images of the raw batch,
    whatever the sample buckets, and launches no kernel wrapper."""
    from multimodal_deepfake_detection_tpu_torch.models import serve as tserve

    seen = []
    amax = tserve.calibrate_amax
    monkeypatch.setattr(tserve, "calibrate_amax",
                        lambda tree, x, **kw: seen.append(tuple(x.shape)) or amax(tree, x, **kw))
    tsc = _port(setup, sample_buckets=(3200,))
    tsc.calibrate(setup["waves"])
    assert seen == [(8, 64, 64, 3)]
