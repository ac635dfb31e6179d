"""The port's exported scoring programs (``models/export.py``,
``models/artifact.py``) and its kernels as custom ops, fp32 on the CPU.

- Each ``torch.ops.mdfd`` op passes ``torch.library.opcheck`` (K1 in both
  tap orders: the seven launch counters), and each public wrapper on fake
  CUDA tensors, as ``torch.export`` traces on the card, takes its op's fake
  implementation and counts no launch.
- Each engine's artifact, replayed through ``ArtifactScorer``, equals its
  live scorer bit for bit at B = 1 and B = 3 from one symbolic-batch
  artifact: the program is the live ``score()``'s own device side.
- The visual and audio artifacts agree with the JAX package's artifacts of
  the same weights (``export_visual`` / ``export_audio`` with
  ``use_pallas=False``, replayed by its ``ArtifactScorer``) within atol 1e-4.
- Exported with the kernels on, each kernel path's graph holds one ``mdfd``
  node per launch of the live call (8 K1 on the fp path; 8 K2 and 10
  ``dw_w8a8`` on ``w8a8-pallas``; ...), and replays bit for bit.
- The manifest, a raw ``torch.export.save`` blob, the au_face exact-bucket
  rule and the device pin.

Small sizes throughout: frames of 32^2, T <= 4, hidden 8, 1,600-sample
waveforms; one export per engine, shared by the module's tests.
"""
import numpy as np
import pytest
import torch

from multimodal_deepfake_detection_tpu_torch.models import export as E
from multimodal_deepfake_detection_tpu_torch.models.artifact import ArtifactScorer
from multimodal_deepfake_detection_tpu_torch.models.au_face import AUFaceDetector
from multimodal_deepfake_detection_tpu_torch.models.heads import ArcFace, XceptionLSTM
from multimodal_deepfake_detection_tpu_torch.models.resnet_lstm import AUPatchClassifier
from multimodal_deepfake_detection_tpu_torch.models.serve import (
    AudioScorer,
    AUFaceScorer,
    AUPatchScorer,
    AVScorer,
    VisualScorer,
)
from multimodal_deepfake_detection_tpu_torch.ops.conv import BatchNorm

HIDDEN, T, SIZE, SAMPLES = 8, 4, 32, 1600
F32 = dict(compute_dtype=torch.float32, device="cpu")
JAX_TOL = 1e-4


def _u8(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _waves(seed, B):
    return np.random.default_rng(seed).normal(0, 0.1, (B, SAMPLES)).astype(np.float32)



@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the module, restored after: in the tier-1 run
    six test workers share the cores, and torch's default of one thread per
    core made these small ops several times slower."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

@pytest.fixture(scope="module")
def model():
    """XceptionLSTM(8) + ArcFace with random BN statistics (the fold runs)."""
    g = torch.Generator().manual_seed(0)
    m = XceptionLSTM(HIDDEN, generator=g)
    with torch.no_grad():
        for bn in (mod for mod in m.modules() if isinstance(mod, BatchNorm)):
            n = bn.mean.shape[0]
            bn.scale.copy_(0.8 + 0.4 * torch.rand(n, generator=g))
            bn.bias.copy_(0.05 * torch.randn(n, generator=g))
            bn.mean.copy_(0.1 * torch.randn(n, generator=g))
            bn.var.copy_(0.5 + torch.rand(n, generator=g))
    return m, ArcFace(HIDDEN, 2, generator=g)


@pytest.fixture(scope="module")
def visual(model):
    """The plain fp32 visual scorer (no kernel: the JAX ``use_pallas=False``
    path), its artifact at T = 4 and the artifact loaded."""
    live = VisualScorer(*model, buckets=(T,), **F32)
    blob = E.export_visual(live, T, SIZE, SIZE)
    return live, blob, ArtifactScorer(blob, engine="visual")


@pytest.fixture(scope="module")
def audio(model):
    live = AudioScorer(model[0], **F32)
    blob = E.export_audio(live, SAMPLES)
    return live, blob, ArtifactScorer(blob)


def _both_batches(art, live, make):
    """The artifact's scores and the live scorer's at B = 1 and B = 3."""
    for B in (1, 3):
        args = make(B)
        got, want = art.score(*args), live.score(*args)
        assert got.shape == (B,) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def _visual_args(B):
    return _u8(B, (B, 3, SIZE, SIZE, 3)), np.array([3, 1, 2][:B], np.int32)


def test_visual_artifact_is_the_live_scorer(visual):
    live, _, art = visual
    assert art.buckets == [(T,)] and art.device == torch.device("cpu")
    _both_batches(art, live, _visual_args)


def test_audio_artifact_is_the_live_scorer(audio):
    live, _, art = audio
    assert art.engine == "audio" and art.hop_length == 160
    _both_batches(art, live, lambda B: (_waves(B, B),))


def _jax_trees(model):
    from multimodal_deepfake_detection_tpu_torch.utils.jax_weights import (
        arcface_to_jax,
        xception_lstm_to_jax,
    )

    params, state = xception_lstm_to_jax(model[0])
    return params, state, arcface_to_jax(model[1])


def test_visual_artifact_matches_the_jax_artifact(model, visual):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from multimodal_deepfake_detection_tpu.models import serve as jserve
    from multimodal_deepfake_detection_tpu.models.artifact import ArtifactScorer as JaxArtifact
    from multimodal_deepfake_detection_tpu.models.export import export_visual

    params, state, arc = _jax_trees(model)
    jsc = jserve.VisualScorer(dict(params, arcface=arc), state, compute_dtype=jnp.float32,
                              use_pallas=False)
    frames, lengths = _visual_args(3)
    want = JaxArtifact(export_visual(jsc, T=T, H=SIZE, W=SIZE)).score(frames, lengths)
    got = visual[2].score(frames, lengths)
    np.testing.assert_allclose(got, want, rtol=0, atol=JAX_TOL)


def test_audio_artifact_matches_the_jax_artifact(model, audio):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from multimodal_deepfake_detection_tpu.models import serve as jserve
    from multimodal_deepfake_detection_tpu.models.artifact import ArtifactScorer as JaxArtifact
    from multimodal_deepfake_detection_tpu.models.export import export_audio

    params, state, _ = _jax_trees(model)
    jsc = jserve.AudioScorer(params, state, compute_dtype=jnp.float32, use_pallas=False)
    waves = _waves(7, 3)
    want = JaxArtifact(export_audio(jsc, SAMPLES)).score(waves)
    np.testing.assert_allclose(audio[2].score(waves), want, rtol=0, atol=JAX_TOL)


@pytest.fixture(scope="module")
def au_face():
    live = AUFaceScorer(AUFaceDetector(4, generator=torch.Generator().manual_seed(1)), **F32)
    return live, E.export_au_face(live, 3, 2, 2, (SIZE, SIZE), (16, 16))


def test_au_face_artifact_is_the_live_scorer(au_face):
    live, blob = au_face
    art = ArtifactScorer(blob)
    assert art.engine == "au_face" and art.buckets == [(3, 2)]

    def args(B):
        mask = (np.random.default_rng(B).random((B, 2, 2)) > 0.3).astype(np.float32)
        return _u8(B, (B, 3, SIZE, SIZE, 3)), _u8(B + 1, (B, 2, 2, 16, 16, 3)), mask

    _both_batches(art, live, args)
    with pytest.raises(ValueError, match="bake"):  # (T, Ta) must match exactly
        art.score(_u8(0, (1, 2, SIZE, SIZE, 3)), _u8(1, (1, 2, 2, 16, 16, 3)))


@pytest.fixture(scope="module")
def au_patch():
    model = AUPatchClassifier(8, 4, generator=torch.Generator().manual_seed(2))
    live = AUPatchScorer(model, **F32)
    return live, E.export_au_patch(live, 3, 2, (16, 16))


def _patch_args(B):
    weights = np.random.default_rng(B).random((B, 3, 2)).astype(np.float32)
    return _u8(B, (B, 3, 2, 16, 16, 3)), weights, np.array([3, 2, 1][:B])


def test_au_patch_artifact_is_the_live_scorer(au_patch):
    live, blob = au_patch
    _both_batches(ArtifactScorer(blob), live, _patch_args)


def test_raw_blob_engine_from_the_signature(au_patch):
    """A bare ``torch.export.save`` blob has no manifest: the engine comes
    from the program's inputs, and it scores as the container does."""
    live, blob = au_patch
    raw = E._unwrap(blob)
    assert E.read_manifest(raw) is None
    art = ArtifactScorer(raw)  # detect_engine reads the program's inputs
    assert art.engine == "au_patch" and art.hop_length == 160
    np.testing.assert_array_equal(art.score(*_patch_args(3)), live.score(*_patch_args(3)))


def test_av_artifact_is_the_live_scorer(model):
    """One artifact for both engines, each on its kernel path (the plain
    versions on the CPU), and the fusion."""
    av = AVScorer(VisualScorer(*model, buckets=(T,), use_kernels=True, **F32),
                  AudioScorer(model[0], use_kernels=True, **F32), alpha=0.3)
    art = ArtifactScorer(E.export_av(av, T, SIZE, SIZE, SAMPLES))
    assert art.engine == "av" and art.buckets == [(T, SAMPLES)]
    _both_batches(art, av, lambda B: (_u8(B, (B, 3, SIZE, SIZE, 3)), _waves(B, B)))


def test_manifest_round_trips(visual, audio, au_face):
    m = E.read_manifest(visual[1])
    assert m == {"format": 1, "version": "0.1.0", "engine": "visual", "T": T, "H": SIZE,
                 "W": SIZE, "quant": None, "compute_dtype": "float32", "device": "cpu"}
    m = E.read_manifest(audio[1])
    assert (m["engine"], m["num_samples"], m["hop_length"]) == ("audio", SAMPLES, 160)
    m = E.read_manifest(au_face[1])
    assert (m["T"], m["Ta"], m["A"], m["face_hw"], m["patch_hw"]) == (3, 2, 2, [32, 32], [16, 16])
    assert visual[1].startswith(E.MAGIC) and E.MAGIC != b"MDFDJXPG"


def test_artifact_is_pinned_to_its_device(visual):
    """Exported on the CPU: serving it on CUDA raises before anything loads."""
    with pytest.raises(ValueError, match="exported on cpu"):
        ArtifactScorer(visual[1], device="cuda")
    with pytest.raises(ValueError, match="exported on cpu"):
        E.load_exported(visual[1], device="cuda:0")


def test_uncalibrated_quantized_scorer_does_not_export(model):
    live = VisualScorer(*model, quantize="w8a8-pallas", **F32)
    with pytest.raises(ValueError, match="calibrate"):
        E.export_visual(live, 2, SIZE, SIZE)


# each kernel path of the visual engine: scorer options -> mdfd nodes per call
KERNEL_PATHS = {
    "fp": ({}, {"middle_block": 8}),
    # a static batch of 4 as well: B = 2 pads to it, B = 5 raises
    "fuse_entry+fuse_exit": (dict(fuse_entry=True, fuse_exit=True),
                             {"middle_block": 8, "entry_block": 4, "sepconv_unit": 2}),
    "entry_pair+middle_taps_bf16": (dict(entry_pair=True, middle_taps="bf16"),
                                    {"middle_block_bf16taps": 8, "entry_pair": 4}),
    "w8a8-pallas": (dict(quantize="w8a8-pallas"), {"middle_block_w8": 8, "dw_w8a8": 10}),
}  # w8a8-hybrid and w8a8 export through the same walk; chip_smoke.py phase 10 holds them


@pytest.mark.parametrize("path", list(KERNEL_PATHS))
def test_kernel_paths_export_as_mdfd_nodes(model, path):
    """``use_kernels=True`` on the CPU: each kernel is one ``mdfd`` node of
    the graph (its plain version runs in the op's CPU implementation), as
    many as the live call launches on the card; the calibrated scales and
    int8 weights go into the program, which replays bit for bit (padded to
    a larger static batch, within 1e-6)."""
    kw, nodes = KERNEL_PATHS[path]
    live = VisualScorer(*model, use_kernels=True, **kw, **F32)
    frames = _u8(5, (2, 2, SIZE, SIZE, 3))
    live.calibrate(frames)
    static = path == "fuse_entry+fuse_exit"
    # static batches: the symbolic one of the engine tests traces slower
    blob = E.export_visual(live, 2, SIZE, SIZE, batch=4 if static else 2)
    art = ArtifactScorer(blob)
    (program,) = art.programs.values()
    assert E.kernel_nodes(program) == nodes
    assert E.read_manifest(blob)["quant"] == kw.get("quantize")
    if static:  # the LSTM's matmuls round differently at B = 4 than at B = 2
        np.testing.assert_allclose(art.score(frames), live.score(frames), rtol=0, atol=1e-6)
        with pytest.raises(ValueError, match="static batch"):
            art.score(_u8(6, (5, 2, SIZE, SIZE, 3)))
    else:
        np.testing.assert_array_equal(art.score(frames), live.score(frames))


def _op_args(name):
    """Small operands of each op (odd N, H and W; rows padded past C)."""
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(s, generator=g)
    x = r(3, 3, 5, 16)
    if name.startswith("middle_block") and name != "middle_block_w8":
        return (x, r(3, 9, 16), r(3, 16, 32).bfloat16(), r(3, 16),
                "bf16" if name.endswith("bf16taps") else "fp32")
    if name == "middle_block_w8":
        pw_q = torch.randint(-127, 128, (3, 16, 64), generator=g, dtype=torch.int8)
        return (x, r(3, 9, 16), pw_q, r(3, 16).abs() / 100, r(3, 16).abs() / 10 + 0.1,
                r(3).abs() / 10 + 0.1, r(3, 16))
    if name == "dw_w8a8":
        w_q = torch.randint(-127, 128, (16, 1, 3, 3), generator=g, dtype=torch.int8)
        return x, w_q, r(16).abs() / 10 + 0.1, r(16).abs() / 100, torch.bfloat16
    pair = (r(9, 16), r(24, 32).bfloat16(), r(24), r(9, 24), r(8, 32).bfloat16(), r(8))
    if name == "entry_block":
        return (x,) + pair + (r(8, 32).bfloat16(), r(8), True)
    if name == "entry_pair":
        return (x,) + pair + (False, False, True)
    return x, r(9, 16), r(24, 32).bfloat16(), r(24), True, False


@pytest.mark.parametrize("name", ["middle_block", "middle_block_bf16taps", "middle_block_w8",
                                  "dw_w8a8", "entry_block", "entry_pair", "sepconv_unit"])
def test_opcheck(name):
    """Schema, fake implementation (shapes, dtypes, strides) and dispatch of
    each op; the CPU implementation is the kernel's plain version."""
    op = getattr(torch.ops.mdfd, name.removesuffix("_bf16taps")).default
    torch.library.opcheck(op, _op_args(name))


def _wrapper_call(name, args):
    """``(counter, output)``: the public wrapper whose ``.launches`` counts
    ``name``'s launches, and its output on the op's positional ``args``."""
    from multimodal_deepfake_detection_tpu_torch.ops.kernels import (
        dw_w8a8,
        entry_block,
        entry_pair,
        middle_block,
        middle_block_w8,
        sepconv_unit,
    )

    if name in ("middle_block", "middle_block_bf16taps"):
        counter = getattr(middle_block, name)
        return counter, middle_block.middle_block(*args[:-1], taps=args[-1])
    if name in ("middle_block_w8", "dw_w8a8"):
        fn = {"middle_block_w8": middle_block_w8.middle_block_w8, "dw_w8a8": dw_w8a8.dw_w8a8}[name]
        return fn, fn(*args)
    if name == "entry_block":
        fn = entry_block.entry_block
        return fn, fn(*args[:-1], leading_relu0=args[-1])
    if name == "entry_pair":
        lead, col, mid = args[-3:]
        fn = entry_pair.entry_pair
        return fn, fn(*args[:-3], leading_relu0=lead, col_sums=col, mid_fp32=mid)
    fn = sepconv_unit.sepconv_unit
    return fn, fn(*args[:-2], leading_relu=args[-2], trailing_relu=args[-1])


@pytest.mark.parametrize("name", ["middle_block", "middle_block_bf16taps", "middle_block_w8",
                                  "dw_w8a8", "entry_block", "entry_pair", "sepconv_unit"])
def test_tracing_counts_no_launch(name):
    """Fake CUDA tensors, as ``torch.export`` traces a program on the card:
    each public wrapper goes through its op's fake implementation, which
    gives the CPU output's shape and dtype and launches, so counts, nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    args = _op_args(name)
    counter, want = _wrapper_call(name, args)
    before = counter.launches
    with FakeTensorMode():
        fake = tuple(torch.empty(a.shape, dtype=a.dtype, device="cuda")
                     if isinstance(a, torch.Tensor) else a for a in args)
        out = _wrapper_call(name, fake)[1]
    assert counter.launches == before
    assert (out.device.type, tuple(out.shape), out.dtype) == ("cuda", tuple(want.shape), want.dtype)
