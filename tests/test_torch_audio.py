"""The port's audio engine against the JAX package, fp32 on the CPU.

One JAX-initialised XceptionLSTMA tree (hidden 8, randomised BN statistics,
so folding is exercised) is loaded into both packages through the weight
bridge; seeded numpy waveforms of 800-4,800 samples go through both. The
images stay 64^2, as the engine fixes them. Bounds, each at its test:

- ``mfcc``: atol 2e-3, rtol 1e-5 on values up to ~220 dB-scaled units
  (CPU reading: 1.0e-4; the two sides sum the FFT and the mel matmul in
  different orders);
- the 13 x 1 -> 64^2 images: atol 1e-6 at unit scale (reading 2.4e-7), and
  atol 1e-6 of the largest value at MFCC scale (one fp32 ulp there);
- the MLP head: atol 1e-5;
- ``AudioScorer``: per-frame features rtol 1e-3 / atol 2e-4 (the bar of
  tests/test_xception.py), scores atol 1e-4, against the JAX
  ``AudioScorer(use_pallas=False)``.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from multimodal_deepfake_detection_tpu.models import serve as jserve  # noqa: E402
from multimodal_deepfake_detection_tpu.models.fold import folded_xception_apply  # noqa: E402
from multimodal_deepfake_detection_tpu.models.heads import (  # noqa: E402
    arcface_init,
    xception_lstm_head_apply as jax_head_apply,
    xception_lstm_init,
)
from multimodal_deepfake_detection_tpu.ops import mfcc as jmfcc  # noqa: E402
from multimodal_deepfake_detection_tpu.ops.resize import resize_bilinear  # noqa: E402
from multimodal_deepfake_detection_tpu_torch.models.heads import (  # noqa: E402
    xception_lstm_head_apply,
)
from multimodal_deepfake_detection_tpu_torch.models.serve import (  # noqa: E402
    AudioScorer,
    AVScorer,
    VisualScorer,
    mfcc_images,
)
from multimodal_deepfake_detection_tpu_torch.ops import mfcc as tmfcc  # noqa: E402
from multimodal_deepfake_detection_tpu_torch.utils import jax_weights  # noqa: E402

from test_torch_serve import _randomize_bn  # noqa: E402

HIDDEN = 8
FEAT_TOL = dict(rtol=1e-3, atol=2e-4)
MFCC_TOL = dict(rtol=1e-5, atol=2e-3)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def trees():
    params, state = xception_lstm_init(jax.random.PRNGKey(3), HIDDEN)
    params, state = _np_tree(params), _np_tree(state)
    _randomize_bn(params["backbone"], state["backbone"], np.random.default_rng(3))
    return params, state


def _waves(B, L, seed):
    return np.random.default_rng(seed).normal(0, 0.1, (B, L)).astype(np.float32)


def _port(trees, **kw):
    return AudioScorer(jax_weights.xception_lstm_from_jax(*trees), compute_dtype=torch.float32,
                       device="cpu", **kw)


def _jax(trees, **kw):
    return jserve.AudioScorer(*trees, compute_dtype=jnp.float32, use_pallas=False, **kw)


@pytest.mark.parametrize("L,center", [(1600, True), (1733, True), (4800, True), (800, True),
                                      (1600, False), (1733, False)])
def test_mfcc_matches_jax(L, center):
    """Lengths that are (1600, 4800, 800) and are not (1733) multiples of
    the hop, centred on the device and not."""
    y = _waves(2, L, seed=L)
    ref = np.asarray(jmfcc.mfcc(jnp.asarray(y), center=center))
    got = tmfcc.mfcc(torch.from_numpy(y), center=center).numpy()
    assert got.shape == ref.shape == (2, 1 + (L if center else L - 400) // 160, 13)
    np.testing.assert_allclose(got, ref, **MFCC_TOL)


def test_mfcc_constants_equal_jax():
    """The filterbank and the DCT are numpy copies: equal to the bit."""
    np.testing.assert_array_equal(tmfcc.mel_filterbank(16000, 400),
                                  jmfcc.mel_filterbank(16000, 400))
    np.testing.assert_array_equal(tmfcc.mel_filterbank(22050, 512, 40),
                                  jmfcc.mel_filterbank(22050, 512, 40))
    np.testing.assert_array_equal(tmfcc.dct_matrix(13, 128), jmfcc.dct_matrix(13, 128))


def test_power_to_db_max_is_per_spectrogram():
    """The top_db floor takes each spectrogram's max over frames x mels:
    zero frames (a bucket's padding) are floored under their own row's max."""
    S = np.abs(np.random.default_rng(0).normal(size=(3, 7, 5))).astype(np.float32)
    S[1] *= 1e-3
    S[2, 4:] = 0.0
    ref = np.asarray(jmfcc.power_to_db(jnp.asarray(S)))
    got = tmfcc.power_to_db(torch.from_numpy(S)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("scale", [1.0, 200.0])
def test_mfcc_images_match_jax(scale):
    """``(B, T, 13)`` -> ``(B*T, 64, 64, 3)`` as ``serve.py:304-311`` of the
    JAX package builds them."""
    f = (np.random.default_rng(1).normal(size=(2, 5, 13)) * scale).astype(np.float32)
    ref = np.asarray(resize_bilinear(
        jnp.broadcast_to(jnp.asarray(f).reshape(10, 13, 1, 1), (10, 13, 1, 3)), (64, 64)))
    got = mfcc_images(torch.from_numpy(f)).numpy()
    assert got.shape == (10, 64, 64, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("lengths,mask_padding", [([5, 3, 1], True), ([5, 3, 1], False),
                                                  (None, True)])
def test_head_apply_matches_jax(trees, lengths, mask_padding):
    params, state = trees
    feats = np.random.default_rng(2).normal(size=(3, 5, 2048)).astype(np.float32)
    model = jax_weights.xception_lstm_from_jax(params, state)
    lens = None if lengths is None else np.asarray(lengths, np.int32)
    as_ = lambda to: None if lens is None else to(lens)
    ref = jax_head_apply(params, jnp.asarray(feats), lengths=as_(jnp.asarray),
                         mask_padding=mask_padding, compute_dtype=jnp.float32)
    with torch.no_grad():
        got = xception_lstm_head_apply(model, torch.from_numpy(feats),
                                       lengths=as_(torch.from_numpy), mask_padding=mask_padding,
                                       compute_dtype=torch.float32)
    assert got.shape == (3, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def _jax_features(jsc, waves, centered):
    imgs, B, T = jsc._wave_to_imgs(jnp.asarray(waves), centered)
    return np.asarray(folded_xception_apply(jsc.folded_backbone, imgs, compute_dtype=jnp.float32,
                                            features_only=True)).reshape(B, T, -1)


# (scorer options, waveforms (B, L), score kwargs); buckets (1600, 3200)
CASES = {
    "plain": ({}, (2, 1733), {}),
    "plain, frame lengths": ({}, (2, 1600), dict(frame_lengths=np.array([11, 6], np.int32))),
    "mask_padding=False": (dict(mask_padding=False), (2, 1733),
                           dict(frame_lengths=np.array([11, 6], np.int32))),
    "sample_buckets": (dict(sample_buckets=(3200, 1600)), (2, 1733), {}),
    "sample_buckets, truncated": (dict(sample_buckets=(800, 1600)), (2, 2500), {}),
    "sample_lengths": ({}, (3, 2400), dict(sample_lengths=np.array([2400, 1733, 800]))),
    "sample_lengths, bucketed": (dict(sample_buckets=(3200,)), (3, 2400),
                                 dict(sample_lengths=np.array([2400, 1733, 800]))),
    "sample_lengths, truncated": (dict(sample_buckets=(1600,), mask_padding=False), (2, 2400),
                                  dict(sample_lengths=np.array([2400, 1000]))),
}


@pytest.mark.parametrize("case", list(CASES))
def test_audio_scorer_matches_jax(trees, case):
    """Every branch of ``score``: uniform length (centred on the device),
    ``sample_buckets`` (centred on the host, zero-padded to the bucket,
    framed uncentred), per-row ``sample_lengths``, each with its truncation
    past the largest bucket, and ``mask_padding=False``."""
    opts, (B, L), kw = CASES[case]
    waves = _waves(B, L, seed=B * L)
    jsc, tsc = _jax(trees, **opts), _port(trees, **opts)
    ref = jsc.score(waves, **kw)
    got = tsc.score(waves, **kw)
    assert got.shape == (B,) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    if "sample_lengths" not in kw and "sample_buckets" not in opts:
        np.testing.assert_allclose(tsc.frame_features(waves).numpy(),
                                   _jax_features(jsc, waves, True), **FEAT_TOL)


def test_audio_features_uncentred_match_jax(trees):
    """The bucketed branch's features: the host-centred, zero-padded waves
    framed uncentred, through both packages."""
    tsc = _port(trees, sample_buckets=(3200,))
    waves = _waves(2, 1733, seed=5)
    prepared, frame_lengths, centered = tsc._prepare(waves, None, None)
    assert not centered and prepared.shape == (2, 3600) and list(frame_lengths) == [11, 11]
    got = tsc.frame_features(waves).numpy()
    np.testing.assert_allclose(got, _jax_features(_jax(trees), prepared, False), **FEAT_TOL)


def test_bucketed_scores_equal_unbucketed(trees):
    """As tests/test_serve_buckets.py requires of the JAX engine: the host
    centring keeps every frame of the true length, so buckets change no
    score; per-row sample lengths score each row as alone."""
    plain, bucketed = _port(trees), _port(trees, sample_buckets=(1600, 3200))
    waves = _waves(2, 1733, seed=7)
    np.testing.assert_allclose(bucketed.score(waves), plain.score(waves), rtol=1e-5, atol=1e-6)
    mixed = np.zeros((2, 2400), np.float32)
    mixed[0], mixed[1, :1733] = _waves(1, 2400, seed=8)[0], waves[1]
    got = plain.score(mixed, sample_lengths=np.array([2400, 1733]))
    np.testing.assert_allclose(got[1], plain.score(waves[1:])[0], rtol=1e-5, atol=1e-6)


def test_sample_lengths_refusals(trees):
    tsc = _port(trees)
    waves = _waves(2, 1600, seed=9)
    with pytest.raises(ValueError, match="n_fft//2"):
        tsc.score(waves, sample_lengths=np.array([1600, 200]))
    with pytest.raises(ValueError, match=r"sample_lengths must be \(2,\)"):
        tsc.score(waves, sample_lengths=np.array([1600]))


@pytest.fixture(scope="module")
def arcface():
    return _np_tree(arcface_init(jax.random.PRNGKey(4), HIDDEN, 2))


def test_av_scorer_matches_jax(trees, arcface):
    """The fused scores against the JAX ``AVScorer``, and the fusion rule
    against the port's two engines scored alone."""
    params, state = trees
    frames = np.random.default_rng(10).integers(0, 255, (2, 3, 32, 32, 3), np.uint8)
    lengths = np.array([3, 2], np.int32)
    waves = _waves(2, 1733, seed=11)
    visual = VisualScorer(jax_weights.xception_lstm_from_jax(params, state),
                          jax_weights.arcface_from_jax(arcface), compute_dtype=torch.float32,
                          device="cpu", buckets=(4,))
    audio = _port(trees, sample_buckets=(3200,))
    got = AVScorer(visual, audio, alpha=0.3).score(frames, waves, lengths)
    jv = jserve.VisualScorer(dict(params, arcface=arcface), state, compute_dtype=jnp.float32,
                             use_pallas=False, buckets=(4,))
    ref = jserve.AVScorer(jv, _jax(trees, sample_buckets=(3200,)), alpha=0.3).score(
        frames, waves, lengths)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    alone = 0.3 * visual.score(frames, lengths) + 0.7 * audio.score(waves)
    np.testing.assert_allclose(got, alone, rtol=0, atol=1e-7)
    with pytest.raises(ValueError, match="share B"):
        AVScorer(visual, audio).score(frames, waves[:1])
    with pytest.raises(ValueError, match="alpha"):
        AVScorer(visual, audio, alpha=1.5)
