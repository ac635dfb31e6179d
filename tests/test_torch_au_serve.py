"""``AUFaceScorer``, ``AUPatchScorer`` and ``cli/serve.py --engine
au_face|au_patch`` against the JAX package, fp32 on the CPU.

The trees of ``au_trees.py`` (randomised BN statistics) go into both
packages: as JAX param trees, bridged into the port, and as JAX-format
bundles for both CLIs. The inputs are seeded uint8 arrays: 2 clips of 3
frames of 32^2 and 3 x 3 AU patches of 16^2, one clip of length 2, padded
to the bucket 4. Every JAX scoring program compiles once: the scorer tests
and the CLI tests share their shapes. The JAX CLI's bundle loaders
initialise a template tree eagerly (about 10 s per ResNet-18 on the CPU),
so here they get the same-shaped tree of ``au_trees.py`` instead: the
strict merge replaces every leaf with the bundle's.

Bars and CPU readings (max |d|):

- fp32 scores against the JAX scorers: atol 1e-4 (readings 0 and 0: the
  same fp32 scores);
- bucketed against unbucketed scores, in the port: atol 1e-6 (readings 0);
- w8a8: the JAX scorer's calibrated tree bridged into the port's scorer
  against the JAX scorer holding it, atol 1e-5 (readings: AU-patch 0, also
  refined; AU-face 3.2e-6); the port's own ``calibrate`` against the JAX
  scorer's, atol 1e-3 (the amaxes differ in fp32 rounding, which can move
  a scale and flip int8 codes; readings: AU-patch 1.5e-6, refined 7.4e-6; AU-face 2.7e-5);
- both CLIs' JSONL scores: atol 1e-4 (both round to 6 places; readings 0);
  the AU-face CLI's score of the short clip against that clip scored alone
  differs by 3.6e-4, the quirk both CLIs share.
"""
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from multimodal_deepfake_detection_tpu.cli import serve as jcli  # noqa: E402
from multimodal_deepfake_detection_tpu.core.checkpoint import save_bundle  # noqa: E402
from multimodal_deepfake_detection_tpu.models import au_face as jau  # noqa: E402
from multimodal_deepfake_detection_tpu.models import resnet_lstm as jrl  # noqa: E402
from multimodal_deepfake_detection_tpu.models import serve as jserve  # noqa: E402
from multimodal_deepfake_detection_tpu_torch.cli import serve as tcli  # noqa: E402
from multimodal_deepfake_detection_tpu_torch.models.serve import (  # noqa: E402
    AUFaceScorer,
    AUPatchScorer,
)
from multimodal_deepfake_detection_tpu_torch.utils import jax_weights  # noqa: E402

from au_trees import FACE_LSTM, PATCH_HIDDEN, PATCH_LSTM, face_tree, patch_tree  # noqa: E402

BUCKETS = (4,)
F32 = jnp.float32


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(21)
    videos = rng.integers(0, 256, (2, 3, 32, 32, 3), np.uint8)
    patches = rng.integers(0, 256, (2, 3, 3, 16, 16, 3), np.uint8)
    weights = rng.uniform(0.1, 1.0, (2, 3, 3)).astype(np.float32)
    mask = np.ones((2, 3, 3), np.float32)
    mask[1, 2] = 0.0  # clip 1's AU stack has 2 steps: its padded step is masked
    return dict(videos=videos, patches=patches, weights=weights, mask=mask,
                lengths=np.array([3, 2], np.int32))


def _patch_scorers(**kw):
    params, state = patch_tree()
    return (jserve.AUPatchScorer(params, state, compute_dtype=F32, buckets=BUCKETS, **kw),
            AUPatchScorer(jax_weights.au_patch_from_jax(params, state),
                          compute_dtype=torch.float32, device="cpu", buckets=BUCKETS, **kw))


def _face_scorers(**kw):
    params, state = face_tree()
    return (jserve.AUFaceScorer(params, state, compute_dtype=F32, buckets=BUCKETS, **kw),
            AUFaceScorer(jax_weights.au_face_from_jax(params, state), compute_dtype=torch.float32,
                         device="cpu", buckets=BUCKETS, **kw))


def test_au_patch_scorer_matches_jax(inputs):
    jsc, tsc = _patch_scorers()
    args = (inputs["patches"], inputs["weights"], inputs["lengths"])
    got = tsc.score(*args)
    assert got.shape == (2,) and got.dtype == np.float32
    np.testing.assert_allclose(got, jsc.score(*args), rtol=0, atol=1e-4)
    pooled = tsc.embed(*args)
    assert pooled.shape == (2, 2 * PATCH_LSTM) and pooled.dtype == torch.float32


def test_au_face_scorer_matches_jax(inputs):
    jsc, tsc = _face_scorers()
    args = (inputs["videos"], inputs["patches"], inputs["mask"], inputs["weights"])
    got = tsc.score(*args)
    assert got.shape == (2,) and got.dtype == np.float32
    np.testing.assert_allclose(got, jsc.score(*args), rtol=0, atol=1e-4)
    assert tsc.embed(*args).shape == (2, 4 * FACE_LSTM)


@pytest.mark.parametrize("engine", ["au_patch", "au_face"])
def test_bucketed_scores_equal_unbucketed(inputs, engine):
    """The time axes padded to buckets of 4 and 8 score as unpadded; the
    defaults (no mask, no weights, full lengths) are ones and T."""
    params_of = {"au_patch": (patch_tree, jax_weights.au_patch_from_jax, AUPatchScorer),
                 "au_face": (face_tree, jax_weights.au_face_from_jax, AUFaceScorer)}
    tree, bridge, cls = params_of[engine]
    model = bridge(*tree())
    if engine == "au_patch":
        args = (inputs["patches"], inputs["weights"], inputs["lengths"])
        defaults = (inputs["patches"], np.ones((2, 3, 3), np.float32), np.array([3, 3]))
    else:
        args = (inputs["videos"], inputs["patches"], inputs["mask"], inputs["weights"])
        defaults = (inputs["videos"], inputs["patches"], np.ones((2, 3, 3), np.float32),
                    np.ones((2, 3, 3), np.float32))
    plain = cls(model, compute_dtype=torch.float32, device="cpu")
    ref = plain.score(*args)
    for buckets in ((4,), (8,)):
        got = cls(model, compute_dtype=torch.float32, device="cpu", buckets=buckets).score(*args)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(plain.score(*args[:1 if engine == "au_patch" else 2]),
                                  plain.score(*defaults))


def test_quantize_modes_are_none_or_w8a8():
    for cls, model in ((AUPatchScorer, jax_weights.au_patch_from_jax(*patch_tree())),
                       (AUFaceScorer, jax_weights.au_face_from_jax(*face_tree()))):
        with pytest.raises(ValueError, match="None or 'w8a8'"):
            cls(model, device="cpu", quantize="w8a8-pallas")
    params, state = patch_tree()
    with pytest.raises(ValueError, match="None or 'w8a8'"):
        jserve.AUPatchScorer(params, state, quantize="w8a8-pallas")


@pytest.mark.parametrize("passes", [0, 1])
def test_au_patch_w8a8_matches_jax(inputs, passes):
    """The JAX scorer's calibrated (and refined) tree bridged into the port's
    scorer, and the port's own calibration, against the JAX scorer (bars:
    module docstring). The refinement fits in fp32 on both sides here."""
    jsc, tsc = _patch_scorers(quantize="w8a8")
    args = (inputs["patches"], inputs["weights"], inputs["lengths"])
    jsc.calibrate(inputs["patches"], refine_passes=passes)
    ref = jsc.score(*args)
    tsc.calibrate(inputs["patches"], refine_passes=passes)
    np.testing.assert_allclose(tsc.score(*args), ref, rtol=0, atol=1e-3)
    tsc.qbackbones = {"backbone": jax_weights.quantized_resnet18_from_jax(
        _np(jsc._qbackbone))}
    np.testing.assert_allclose(tsc.score(*args), ref, rtol=0, atol=1e-5)


def test_au_face_w8a8_matches_jax(inputs):
    """Both streams int8, calibrated on the first scored batch on both sides."""
    jsc, tsc = _face_scorers(quantize="w8a8")
    args = (inputs["videos"], inputs["patches"], inputs["mask"], inputs["weights"])
    ref = jsc.score(*args)
    with pytest.raises(ValueError, match="calibrate"):
        tsc.features("au_backbone", inputs["patches"])
    np.testing.assert_allclose(tsc.score(*args), ref, rtol=0, atol=1e-3)
    assert tsc.features("au_backbone", inputs["patches"]).shape == (18, 512)
    tsc.qbackbones = {f"{k}_backbone": jax_weights.quantized_resnet18_from_jax(
        _np(jsc._qbackbones[k])) for k in ("face", "au")}
    np.testing.assert_allclose(tsc.score(*args), ref, rtol=0, atol=1e-5)


def test_au_bundles_load_strict_then_lenient(tmp_path):
    """au_face: a bare model tree loads, and a tree missing a weight loads
    non-strictly, the missing weight keeping the port's seeded init, as the
    JAX loader falls back; au_patch loads strictly and raises."""
    from multimodal_deepfake_detection_tpu_torch.models.au_face import AUFaceDetector
    from multimodal_deepfake_detection_tpu_torch.models.serve import (
        load_au_face_bundle,
        load_au_patch_bundle,
    )

    params, state = face_tree()
    save_bundle(str(tmp_path / "bare.npz"), params)
    bare = load_au_face_bundle(str(tmp_path / "bare.npz"), lstm_hidden=FACE_LSTM)
    np.testing.assert_array_equal(bare.face_proj.w.detach().numpy(), params["face_proj"]["w"].T)
    partial = {k: v for k, v in params.items() if k != "head_fc2"}
    save_bundle(str(tmp_path / "partial.npz"), {"model": partial, "state": state})
    got = load_au_face_bundle(str(tmp_path / "partial.npz"), lstm_hidden=FACE_LSTM)
    init = AUFaceDetector(FACE_LSTM, generator=torch.Generator().manual_seed(0))
    assert torch.equal(got.head_fc2.w, init.head_fc2.w)
    np.testing.assert_array_equal(got.au_backbone.bn1.mean.numpy(),
                                  state["au_backbone"]["bn1"]["mean"])
    p_params, p_state = patch_tree()
    save_bundle(str(tmp_path / "patch.npz"), {"model": {k: v for k, v in p_params.items()
                                                        if k != "classifier"}})
    with pytest.raises(KeyError, match="classifier"):
        load_au_patch_bundle(str(tmp_path / "patch.npz"), PATCH_HIDDEN, PATCH_LSTM)


# --- the CLIs -----------------------------------------------------------------

@pytest.fixture(scope="module")
def cli_root(tmp_path_factory, inputs):
    """Bundles and input trees for both engines. au_patch: stack ``a`` as
    float in [0, 1] with a ``_weights.npy`` sibling, ``b`` of 2 steps;
    au_face: ``a`` of 3 frames and 3 AU steps, ``b`` of 2 and 2."""
    root = tmp_path_factory.mktemp("au_serve")
    (root / "patches").mkdir()
    (root / "faces").mkdir()
    (root / "aus").mkdir()
    for name, tree in (("au_patch", patch_tree()), ("au_face", face_tree())):
        save_bundle(str(root / f"{name}.npz"), {"model": tree[0], "state": tree[1],
                                                "embed": {"w": np.zeros((2, 2), np.float32)}})
    p, v = inputs["patches"], inputs["videos"]
    np.save(root / "patches" / "a.npy", p[0].astype(np.float32) / 255.0)
    np.save(root / "patches" / "a_weights.npy", inputs["weights"][0])
    np.save(root / "patches" / "b.npy", p[1, :2])
    np.save(root / "faces" / "a.npy", v[0])
    np.save(root / "faces" / "b.npy", v[1, :2])
    np.save(root / "aus" / "a.npy", p[0])
    np.save(root / "aus" / "b.npy", p[1, :2])
    return root


@pytest.fixture
def template_inits(monkeypatch):
    """The JAX bundle loaders' template trees from ``au_trees.py``."""
    monkeypatch.setattr(jrl, "au_patch_classifier_init", lambda *a, **kw: patch_tree())
    monkeypatch.setattr(jau, "au_face_detector_init", lambda *a, **kw: face_tree())
    monkeypatch.setenv("MDD_NO_COMPILE_CACHE", "1")


def _scores(main, argv, out):
    n = main(argv + ["--output", str(out)], log=lambda s: None)
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert n == len(recs) == 2
    return [r["path"].rsplit("/", 1)[-1] for r in recs], np.array([r["score"] for r in recs])


FLAGS = ["--batch_size", "2", "--compute_dtype", "float32", "--buckets", "4", "--num_aus", "3"]


def test_cli_au_patch_matches_jax_cli(cli_root, template_inits):
    argv = ["--engine", "au_patch", "--ckpt_path", str(cli_root / "au_patch.npz"), "--input",
            str(cli_root / "patches"), "--patch_hidden", str(PATCH_HIDDEN),
            "--patch_lstm_hidden", str(PATCH_LSTM)] + FLAGS
    ref_paths, ref = _scores(jcli.main, argv, cli_root / "jax_patch.jsonl")
    paths, got = _scores(tcli.main, argv + ["--device", "cpu"], cli_root / "port_patch.jsonl")
    assert paths == ref_paths == ["a.npy", "b.npy"]
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_cli_au_face_matches_jax_cli(cli_root, template_inits, inputs):
    """Scored without the clips' lengths on both sides (the JAX CLI's quirk):
    clip ``b``'s padded frame goes through the face stream, so its score
    differs from ``b`` scored alone."""
    argv = ["--engine", "au_face", "--ckpt_path", str(cli_root / "au_face.npz"), "--input",
            str(cli_root / "faces"), "--au_input", str(cli_root / "aus"),
            "--lstm_hidden", str(FACE_LSTM)] + FLAGS
    ref_paths, ref = _scores(jcli.main, argv, cli_root / "jax_face.jsonl")
    paths, got = _scores(tcli.main, argv + ["--device", "cpu"], cli_root / "port_face.jsonl")
    assert paths == ref_paths == ["a.npy", "b.npy"]
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    alone = AUFaceScorer.from_bundle(str(cli_root / "au_face.npz"), lstm_hidden=FACE_LSTM,
                                     compute_dtype=torch.float32, device="cpu")
    b_alone = alone.score(inputs["videos"][1:, :2], inputs["patches"][1:, :2])[0]
    assert abs(b_alone - got[1]) > 1e-6


def test_cli_au_engines_refuse_xception_routes_and_need_au_input(cli_root):
    base = ["--ckpt_path", str(cli_root / "au_face.npz"), "--device", "cpu",
            "--lstm_hidden", str(FACE_LSTM)]
    with pytest.raises(ValueError, match="--au_input"):
        tcli.main(["--engine", "au_face", "--input", str(cli_root / "faces")] + base)
    with pytest.raises(ValueError, match="fuse_exit"):
        tcli.main(["--engine", "au_face", "--fuse_exit", "true"] + base)
