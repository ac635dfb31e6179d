"""The port's evaluation CLIs (``cli/test_visual``, ``test_audio``,
``test_av_fused``, ``test_au_patch``, ``test_au_face``) against the JAX
package's, fp32 on the CPU.

Each CLI runs once per package (a module fixture) on the same seeded npy
tree and the same JAX-format bundle, and the tests read what both wrote
and logged. Trees: 6 clips each (3 real, 3 fake); faces of 32^2 in lengths
3, 6, 2, 7, 5, 4 (buckets 4 and 8, batch 4: two batches, the second padded
with two empty rows), MFCC clips of 3 to 6 steps (bucket 6), AU-patch
stacks of 1 to 3 steps of 3 AUs at 16^2, and face + AU pairs of 3 steps
(faces of 32^2).

Bundles: the visual and audio XceptionLSTMs (hidden 8) and ArcFace are the
port's seeded init with randomised BN statistics (they spread the scores;
the audio MLP head's weights x 4 and biases 0, as the default init leaves
its six scores within 1e-6); the AU trees are ``au_trees.py``'s
(randomised BN statistics, hidden 8 / lstm 4, tokens of 8), the AU-face
bundle's logits x 10. The JAX CLIs get template trees of the right shapes
in place of their eager random inits (a full-width Xception's 20 M normals
take ~10 s on the CPU): the strict merges replace every leaf, and the state
template is the init's (mean 0, var 1), which the test of a bundle without
``state`` reads.

Bars and CPU readings (max |d|):

- saved scores atol 1e-4, labels and order identical (readings: visual
  1.9e-6, audio 9.5e-7, AV fused 9.2e-7, AU-patch 0, AU-face 6.0e-8);
- reported metrics atol 1e-4, counts equal, held only where the smallest
  gap between two JAX scores of a CLI exceeds the score bar (smallest gaps:
  visual 6.4e-3, audio 2.7e-4, AV fused 2.9e-3, AU-patch 1.2e-4, AU-face
  4.2e-4; each asserted above the bar);
- au_patch's embeddings atol 1e-4 (4.5e-8), au_face's mean tokens, the
  t-SNE inputs, atol 1e-4 (1.9e-7);
- saliency maps (one per sample: its frames, or its frames x AUs) within
  1e-3 of the JAX map's max (readings: visual 1.7e-6, AU-patch 1.0e-6 of it).
"""
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from multimodal_deepfake_detection_tpu.cli import test_au_face as jtf  # noqa: E402
from multimodal_deepfake_detection_tpu.cli import test_au_patch as jtp  # noqa: E402
from multimodal_deepfake_detection_tpu.cli import test_audio as jta  # noqa: E402
from multimodal_deepfake_detection_tpu.cli import test_av_fused as jav  # noqa: E402
from multimodal_deepfake_detection_tpu.cli import test_visual as jtv  # noqa: E402
from multimodal_deepfake_detection_tpu.utils import saliency as jsal  # noqa: E402
from multimodal_deepfake_detection_tpu_torch.cli import test_au_face as ttf  # noqa: E402
from multimodal_deepfake_detection_tpu_torch.cli import test_au_patch as ttp  # noqa: E402
from multimodal_deepfake_detection_tpu_torch.cli import test_audio as tta  # noqa: E402
from multimodal_deepfake_detection_tpu_torch.cli import test_av_fused as tav  # noqa: E402
from multimodal_deepfake_detection_tpu_torch.cli import test_visual as ttv  # noqa: E402
from multimodal_deepfake_detection_tpu_torch.core.checkpoint import (  # noqa: E402
    load_bundle,
    save_bundle,
)
from multimodal_deepfake_detection_tpu_torch.models.heads import (  # noqa: E402
    ArcFace,
    XceptionLSTM,
)
from multimodal_deepfake_detection_tpu_torch.utils import jax_weights  # noqa: E402
from multimodal_deepfake_detection_tpu_torch.utils import saliency as tsal  # noqa: E402

from au_trees import FACE_LSTM, PATCH_HIDDEN, PATCH_LSTM, face_tree, patch_tree  # noqa: E402
from train_oracle import randomize_buffers  # noqa: E402

HIDDEN = 8
SCORE_TOL = 1e-4
MAP_TOL = 1e-3  # of each JAX map's max
NAMES = [f"{c}_{i}" for c in ("real", "fake") for i in range(3)]
FACE_T = (3, 6, 2, 7, 5, 4)
MFCC_T = (3, 6, 4, 5, 6, 3)
PATCH_T = (2, 3, 1, 3, 2, 3)
NUM_AUS = 3
FACE_LOGIT_GAIN = 10.0  # the AU-face bundle's logits x 10: its scores spread 10 times wider


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one intra-op thread for this file, restored after: these
    tiny models gain nothing from several, which only contend with the
    other test processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _xception_lstm(seed, head_gain=None):
    """A seeded port XceptionLSTM with randomised BN affine and statistics;
    with ``head_gain``, the MLP head's weights scaled by it and its biases 0
    (the default init shrinks the clips' differences through each of its
    five layers: the audio scores then lie within 1e-6 of one another)."""
    model = randomize_buffers(XceptionLSTM(HIDDEN, generator=torch.Generator().manual_seed(seed)),
                              seed)
    g = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".scale"):
                p.copy_(0.8 + 0.4 * torch.rand(p.shape, generator=g))
            elif name.endswith(".bias") and ".bn" in f".{name}":
                p.copy_(0.05 * torch.randn(p.shape, generator=g))
        for layer in list(model.fc_layers) + [model.fc_out] if head_gain else ():
            layer.w.mul_(head_gain)
            layer.b.zero_()
    return model


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The trees and bundles, written once."""
    root = tmp_path_factory.mktemp("eval")
    rng = np.random.default_rng(15)
    for sub in ("faces", "mfcc", "patches/test", "jv/eval", "ja/eval"):
        os.makedirs(root / sub)
    for name, tf, ta, tp in zip(NAMES, FACE_T, MFCC_T, PATCH_T):
        np.save(root / "faces" / f"{name}.npy", rng.integers(0, 256, (tf, 32, 32, 3), np.uint8))
        np.save(root / "mfcc" / f"{name}.npy", rng.normal(0, 20, (ta, 13)).astype(np.float32))
        np.save(root / "patches" / "test" / f"{name}.npy",
                rng.integers(0, 256, (tp, NUM_AUS, 16, 16, 3), np.uint8))
        np.save(root / "patches" / "test" / f"{name}_weights.npy",
                rng.dirichlet(np.ones(NUM_AUS), size=tp).astype(np.float32))
        np.save(root / "jv" / "eval" / f"{name}.npy",
                rng.integers(0, 256, (3, 32, 32, 3), np.uint8))
        np.save(root / "ja" / "eval" / f"{name}.npy",
                rng.integers(0, 256, (3, NUM_AUS, 16, 16, 3), np.uint8))
        np.save(root / "ja" / "eval" / f"{name}_weights.npy",
                rng.dirichlet(np.ones(NUM_AUS), size=3).astype(np.float32))
    for split in ("train", "eval"):
        os.makedirs(root / "patches" / split)
    for split in ("train", "test"):
        os.makedirs(root / "jv" / split)
        os.makedirs(root / "ja" / split)

    params, state = jax_weights.xception_lstm_to_jax(_xception_lstm(1))
    arc = jax_weights.arcface_to_jax(ArcFace(HIDDEN, 2, generator=torch.Generator().manual_seed(2)))
    save_bundle(str(root / "visual.npz"), {"model": params, "arcface": arc, "state": state})
    params, state = jax_weights.xception_lstm_to_jax(_xception_lstm(3, head_gain=4.0))
    save_bundle(str(root / "audio.npz"), {"model": params, "state": state})
    save_bundle(str(root / "audio_nostate.npz"), {"model": params})
    save_bundle(str(root / "au_patch.npz"), dict(zip(("model", "state"), patch_tree())))
    params, state = face_tree()
    head = {k: v * FACE_LOGIT_GAIN for k, v in params["head_fc2"].items()}
    save_bundle(str(root / "au_face.npz"), {"model": dict(params, head_fc2=head), "state": state})
    return root


def _template_xception(rng, hidden_dim):
    """The shapes of ``xception_lstm_init``, and its state (mean 0, var 1)."""
    tree = jax_weights.xception_lstm_to_jax(XceptionLSTM(hidden_dim))
    return jax.tree_util.tree_map(jnp.asarray, tree)


class _Capture:
    """Wrap ``module.name``: record each call's arguments and result."""

    def __init__(self, mp, module, name):
        self.calls, fn = [], getattr(module, name)

        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            self.calls.append((args, kw, out))
            return out

        mp.setattr(module, name, wrapped)


def _run(jax_main, torch_main, argv, jax_argv=(), torch_argv=(), patches=(), captures=None):
    """Run both CLIs on ``argv``; -> {"jax"|"torch": (results, logs, {capture: calls})}."""
    out = {}
    for side, main, extra in (("jax", jax_main, jax_argv), ("torch", torch_main, torch_argv)):
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("MDD_NO_COMPILE_CACHE", "1")
            for module, name, value in patches:
                mp.setattr(module, name, value)
            caps = {key: _Capture(mp, module, name) for key, (module, name) in
                    (captures or {}).get(side, {}).items()}
            logs = []
            results = main(list(argv) + list(extra), log=logs.append)
            out[side] = (results, logs, {k: c.calls for k, c in caps.items()})
    return out


def _assert_scores(got, want, tol=SCORE_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _min_gap(scores) -> float:
    s = np.sort(np.asarray(scores, np.float64))
    return float(np.diff(s).min())


def _assert_metrics(got: dict, want: dict, scores):
    """The reported metrics, under the ranking-gap rule: held only where
    the smallest gap between two JAX scores exceeds the score bar (the
    trees are chosen so that it does)."""
    assert _min_gap(scores) > SCORE_TOL
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, dict):
            _assert_metrics(got[k], v, scores)
        elif isinstance(v, (int, np.integer)) and not isinstance(v, bool):
            assert got[k] == v, k
        else:
            np.testing.assert_allclose(got[k], v, rtol=0, atol=SCORE_TOL, err_msg=k)


def _assert_maps(got, want):
    """Per sample map: max |d| within MAP_TOL of the JAX map's max."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= MAP_TOL * np.abs(w).max()


# ---------------------------------------------------------------------------
# test_visual
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def visual(root):
    argv = ["--test_folder", str(root / "faces"), "--ckpt_path", str(root / "visual.npz"),
            "--hidden_dim", str(HIDDEN), "--buckets", "4,8", "--compute_dtype", "float32"]
    sal = {"jax": {"grid": (jsal, "save_saliency_grid")},
           "torch": {"grid": (tsal, "save_saliency_grid")}}
    runs = _run(jtv.main, ttv.main, argv,
                jax_argv=["--save_scores", str(root / "jv.npz"),
                          "--saliency_dir", str(root / "jsal_v")],
                torch_argv=["--device", "cpu", "--save_scores", str(root / "tv.npz"),
                            "--saliency_dir", str(root / "tsal_v")],
                patches=[(jtv, "xception_lstm_init", _template_xception)], captures=sal)
    return runs, np.load(root / "jv.npz"), np.load(root / "tv.npz")


def test_visual_scores_match_jax(visual):
    _, j, t = visual
    assert t["labels"].tolist() == j["labels"].tolist() == [1, 1, 1, 0, 0, 0]
    _assert_scores(t["scores"], j["scores"])


def test_visual_report_matches_jax(visual):
    runs, j, _ = visual
    _assert_metrics(runs["torch"][0], runs["jax"][0], j["scores"])
    report = lambda logs: logs[:logs.index(next(x for x in logs if x.startswith("saved")))]  # noqa
    assert report(runs["torch"][1]) == report(runs["jax"][1])  # the metric and classwise lines


def test_visual_saliency_matches_jax(visual, root):
    runs, _, _ = visual
    (jargs, jkw, _), = runs["jax"][2]["grid"]
    (targs, tkw, _), = runs["torch"][2]["grid"]
    np.testing.assert_array_equal(targs[0], jargs[0])  # the first batch's frames
    _assert_maps(targs[1], jargs[1])
    _assert_scores(tkw["scores"], jkw["scores"])
    assert os.path.getsize(root / "tsal_v" / "saliency_batch0.png") > 1000


@pytest.mark.parametrize("argv", [["--mode", "fakeavceleb"], ["--csv_path", "meta.csv"]])
def test_visual_video_modes_raise(argv):
    with pytest.raises(NotImplementedError, match="item 10b"):
        ttv.make_loader(ttv.parse_config(ttv.Config, argv, prog="test_visual"))


# ---------------------------------------------------------------------------
# test_audio (no saved scores: the scores reach compute_eer_auc)
# ---------------------------------------------------------------------------

def _audio_runs(root, bundle):
    argv = ["--test_folder", str(root / "mfcc"), "--ckpt_path", str(root / bundle),
            "--hidden_dim", str(HIDDEN), "--buckets", "6", "--batch_size", "4",
            "--compute_dtype", "float32"]
    caps = {"jax": {"eer": (jta, "compute_eer_auc")}, "torch": {"eer": (tta, "compute_eer_auc")}}
    return _run(jta.main, tta.main, argv, torch_argv=["--device", "cpu"],
                patches=[(jta, "xception_lstm_init", _template_xception)], captures=caps)


@pytest.fixture(scope="module")
def audio(root):
    return _audio_runs(root, "audio.npz")


def test_audio_scores_match_jax(audio):
    (jy, js), _, _ = audio["jax"][2]["eer"][0]
    (ty, ts), _, _ = audio["torch"][2]["eer"][0]
    assert ty.tolist() == jy.tolist() == [1, 1, 1, 0, 0, 0]
    _assert_scores(ts, js)


def test_audio_report_matches_jax(audio):
    (_, js), _, _ = audio["jax"][2]["eer"][0]
    _assert_metrics(audio["torch"][0], audio["jax"][0], js)
    assert audio["torch"][1] == audio["jax"][1]


def test_audio_bundle_without_state_matches_jax(root):
    """Without ``state`` both CLIs log it and score on the initial BN
    statistics (the scores then lie within 1e-4 of one another: only they
    are held)."""
    runs = _audio_runs(root, "audio_nostate.npz")
    line = "[Load] bundle has no BN state; using initialization statistics"
    assert runs["torch"][1][0] == runs["jax"][1][0] == line
    (_, js), _, _ = runs["jax"][2]["eer"][0]
    (_, ts), _, _ = runs["torch"][2]["eer"][0]
    _assert_scores(ts, js)


# ---------------------------------------------------------------------------
# test_av_fused
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def av(root):
    argv = ["--video_folder", str(root / "faces"), "--audio_folder", str(root / "mfcc"),
            "--visual_ckpt", str(root / "visual.npz"), "--audio_ckpt", str(root / "audio.npz"),
            "--visual_hidden", str(HIDDEN), "--audio_hidden", str(HIDDEN),
            "--video_buckets", "4,8", "--audio_buckets", "6", "--compute_dtype", "float32"]
    runs = _run(jav.main, tav.main, argv, jax_argv=["--save_scores", str(root / "jav.npz")],
                torch_argv=["--device", "cpu", "--save_scores", str(root / "tav.npz")],
                patches=[(jav, "xception_lstm_init", _template_xception)])
    return runs, np.load(root / "jav.npz"), np.load(root / "tav.npz")


def test_av_scores_match_jax(av):
    _, j, t = av
    assert sorted(t.files) == sorted(j.files) == ["audio", "fused", "labels", "visual"]
    assert t["labels"].tolist() == j["labels"].tolist() == [1, 1, 1, 0, 0, 0]
    for k in ("visual", "audio", "fused"):
        _assert_scores(t[k], j[k])


def test_av_report_matches_jax(av):
    runs, j, _ = av
    assert runs["torch"][1][0] == runs["jax"][1][0] == "paired clips: 6"
    for stream in ("visual", "audio", "fused"):
        _assert_metrics(runs["torch"][0][stream], runs["jax"][0][stream], j[stream])


# ---------------------------------------------------------------------------
# test_au_patch
# ---------------------------------------------------------------------------

def _jax_patch_tree(*args, **kw):
    return jax.tree_util.tree_map(jnp.asarray, patch_tree())


@pytest.fixture(scope="module")
def au_patch(root):
    argv = ["--data_root", str(root / "patches"), "--ckpt_path", str(root / "au_patch.npz"),
            "--hidden_dim", str(PATCH_HIDDEN), "--lstm_hidden", str(PATCH_LSTM),
            "--image_size", "16", "--max_frames", "3", "--max_aus", str(NUM_AUS),
            "--batch_size", "4", "--compute_dtype", "float32"]
    sal = {"jax": {"grid": (jsal, "save_saliency_grid")},
           "torch": {"grid": (tsal, "save_saliency_grid")}}
    runs = _run(jtp.main, ttp.main, argv,
                jax_argv=["--save_embeddings", str(root / "jemb.npz"),
                          "--saliency_dir", str(root / "jsal_p")],
                torch_argv=["--device", "cpu", "--save_embeddings", str(root / "temb.npz"),
                            "--saliency_dir", str(root / "tsal_p")],
                patches=[(jtp, "au_patch_classifier_init", _jax_patch_tree)], captures=sal)
    return runs, np.load(root / "jemb.npz"), np.load(root / "temb.npz")


def test_au_patch_scores_match_jax(au_patch):
    _, j, t = au_patch
    assert t["labels"].tolist() == j["labels"].tolist() == [1, 1, 1, 0, 0, 0]
    _assert_scores(t["scores"], j["scores"])


def test_au_patch_embeddings_match_jax(au_patch):
    _, j, t = au_patch
    assert t["embeddings"].shape == j["embeddings"].shape == (6, 2 * PATCH_LSTM)
    _assert_scores(t["embeddings"], j["embeddings"])


def test_au_patch_operating_points_match_jax(au_patch):
    """AUC/pAUC/EER, the three thresholds (in the keys) and their counts."""
    runs, j, _ = au_patch
    _assert_metrics(runs["torch"][0], runs["jax"][0], j["scores"])
    assert runs["torch"][1][:4] == runs["jax"][1][:4]


def test_au_patch_saliency_matches_jax(au_patch, root):
    runs, _, _ = au_patch
    (jargs, jkw, _), = runs["jax"][2]["grid"]
    (targs, tkw, _), = runs["torch"][2]["grid"]
    assert targs[1].shape == (4, 3 * NUM_AUS, 16, 16)  # the AU axis unrolled
    np.testing.assert_array_equal(targs[0], jargs[0])
    _assert_maps(targs[1], jargs[1])
    _assert_scores(tkw["scores"], jkw["scores"])
    assert os.path.getsize(root / "tsal_p" / "saliency_batch0.png") > 1000


# ---------------------------------------------------------------------------
# test_au_face
# ---------------------------------------------------------------------------

def _jax_face_tree(*args, **kw):
    return jax.tree_util.tree_map(jnp.asarray, face_tree())


FACE_ARGV = ["--num_aus", str(NUM_AUS), "--face_dim", str(2 * FACE_LSTM), "--au_dim",
             str(2 * FACE_LSTM), "--lstm_hidden", str(FACE_LSTM), "--image_size", "32",
             "--max_frames", "3", "--compute_dtype", "float32"]


@pytest.fixture(scope="module")
def au_face(root):
    """Both CLIs with their t-SNE plots; the pre-flip scores and the
    plots' inputs captured."""
    caps = {side: {"feats": (mod, "collect_features"), "tsne": (mod, "run_tsne_and_plot")}
            for side, mod in (("jax", jtf), ("torch", ttf))}
    argv = ["--video_root", str(root / "jv"), "--au_root", str(root / "ja"),
            "--ckpt_path", str(root / "au_face.npz")] + FACE_ARGV
    runs = _run(jtf.main, ttf.main, argv, jax_argv=["--output_dir", str(root / "jface")],
                torch_argv=["--device", "cpu", "--output_dir", str(root / "tface")],
                patches=[(jtf, "au_face_detector_init", _jax_face_tree)], captures=caps)
    return runs, np.load(root / "jface" / "scores_and_labels.npz"), \
        np.load(root / "tface" / "scores_and_labels.npz")


def test_au_face_scores_match_jax(au_face):
    """The scores before the flip (collect_features) and as saved."""
    runs, j, t = au_face
    (_, _, (_, _, jl, js)), = runs["jax"][2]["feats"]
    (_, _, (_, _, tl, ts)), = runs["torch"][2]["feats"]
    assert tl.tolist() == jl.tolist() == [1, 1, 1, 0, 0, 0]
    _assert_scores(ts, js)
    assert t["labels"].tolist() == j["labels"].tolist()
    _assert_scores(t["scores"], j["scores"])


def test_au_face_flip_decision_matches_jax(au_face):
    runs, _, _ = au_face
    flip = [[line for line in runs[side][1] if line.startswith("[Scores] sign auto-flip")]
            for side in ("jax", "torch")]
    assert len(flip[0]) == len(flip[1])
    (_, _, (_, _, labels, scores)), = runs["jax"][2]["feats"]
    (_, _, (_, _, _, tscores)), = runs["torch"][2]["feats"]
    assert ttf.sign_flip(labels, tscores, log=lambda s: None) == bool(flip[0])
    assert jtf.compute_eer_auc(labels, scores)[0] != 0.5  # a decision to make


def test_au_face_operating_points_match_jax(au_face):
    runs, j, _ = au_face
    _assert_metrics(runs["torch"][0], runs["jax"][0], j["scores"])
    heads = ("[Scores]", "AUC:", "[Youden]", "[FPR")
    report = lambda logs: [line for line in logs if line.startswith(heads)]  # noqa: E731
    assert len(report(runs["jax"][1])) >= 3
    assert report(runs["torch"][1]) == report(runs["jax"][1])


def test_au_face_tsne_inputs_match_jax(au_face, root):
    runs, _, _ = au_face
    jcalls, tcalls = runs["jax"][2]["tsne"], runs["torch"][2]["tsne"]
    assert [c[0][2] for c in tcalls] == [c[0][2] for c in jcalls] == [
        "t-SNE face_stream", "t-SNE au_stream", "t-SNE concat_streams"]
    for (targs, _, _), (jargs, _, _) in zip(tcalls, jcalls):
        assert targs[0].shape == jargs[0].shape
        _assert_scores(targs[0], jargs[0])
        assert targs[1].tolist() == jargs[1].tolist()
    for name in ("face_stream", "au_stream", "concat_streams"):
        assert os.path.getsize(root / "tface" / f"tsne_{name}.png") > 1000


def test_au_face_saliency_writes_face_maps(root):
    """Saliency with respect to the faces only: one map per face, zero
    nowhere on a scored face, the PNG written."""
    with pytest.MonkeyPatch.context() as mp:
        cap = _Capture(mp, tsal, "save_saliency_grid")
        ttf.main(["--video_root", str(root / "jv"), "--au_root", str(root / "ja"),
                  "--ckpt_path", str(root / "au_face.npz"), "--output_dir", str(root / "tf2"),
                  "--tsne", "false", "--saliency_dir", str(root / "tsal_f"), "--device", "cpu"]
                 + FACE_ARGV, log=lambda s: None)
    (args, _, _), = cap.calls
    assert args[1].shape == args[0].shape[:-1] == (2, 3, 32, 32)
    assert (args[1].reshape(6, -1).max(axis=1) > 0).all()
    assert os.path.getsize(root / "tsal_f" / "saliency_batch0.png") > 1000


def test_au_face_fallback_load_lines_match_jax(root):
    """A bundle without ``head_fc2``: both CLIs log the failed strict merge
    and the fallback with the same lines, and every weight the bundle holds
    is loaded (the missing ones keep each package's own init)."""
    params, state = face_tree()
    partial = {k: v for k, v in params.items() if k != "head_fc2"}
    path = str(root / "au_face_partial.npz")
    save_bundle(path, {"model": partial, "state": state})
    cfg = dict(ckpt_path=path, num_aus=NUM_AUS, face_dim=2 * FACE_LSTM, au_dim=2 * FACE_LSTM,
               lstm_hidden=FACE_LSTM)
    jlogs, tlogs = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtf, "au_face_detector_init", _jax_face_tree)
        jtf.load_detector_flexible(jtf.Config(**cfg), jlogs.append)
    scorer = ttf.load_detector_flexible(ttf.Config(device="cpu", **cfg), tlogs.append)
    assert tlogs == jlogs and len(tlogs) == 2
    assert tlogs[0].startswith("[Load] strict failed -> KeyError")
    loaded = jax_weights.au_face_to_jax(scorer.model)
    bundle = load_bundle(path)

    def walk(want, got, path=""):
        if isinstance(want, dict):
            for k in want:
                walk(want[k], got[k], f"{path}/{k}")
        elif isinstance(want, list):
            for i, (a, b) in enumerate(zip(want, got)):
                walk(a, b, f"{path}/{i}")
        else:
            np.testing.assert_array_equal(got, want, err_msg=path)

    walk(bundle["model"], loaded[0])
    walk(bundle["state"], loaded[1])
    assert "head_fc2" in loaded[0]


# ---------------------------------------------------------------------------
# Every CLI: CUDA by default, and no silent CPU path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cli,build", [
    (ttv, lambda c: ttv.build_scorer(c)), (tta, lambda c: tta.build_scorer(c)),
    (tav, lambda c: tav.build_scorer(c)), (ttp, lambda c: ttp.load_model(c)),
    (ttf, lambda c: ttf.load_detector_flexible(c)),
], ids=["test_visual", "test_audio", "test_av_fused", "test_au_patch", "test_au_face"])
def test_cli_defaults_to_cuda_and_raises_without_it(cli, build, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.Config().device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build(cli.Config())
