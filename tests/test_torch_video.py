"""The port's video ingestion against the JAX package's, on the CPU.

Face detection, the native decode engines (built by each package from the
same ``native/*.cc``: the port into its ``build/``, JAX into ``native/``),
the metadata datasets in every mode with their ``sample_percentage`` and
``augment_minority`` draws, the raw-video loader (native decode, and cv2
with face detection) and the CLIs on video: ``cli/serve.py`` on a directory
of videos, ``test_visual --mode lavdf_raw``.

Bars: decoded frames, samples, batches and lengths bit-equal to JAX's; the
CLIs' scores and metrics at fp32 within 1e-4 (the port's CLI bar). Clips are
written here, MJPEG AVI through cv2 and H.264 mp4 through the libav
engine's encoder; as in the JAX tests, the H.264 cases skip without a libav
encoder, and the module without cv2.
"""
import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
cv2 = pytest.importorskip("cv2")
import torch  # noqa: E402

from multimodal_deepfake_detection_tpu.cli import serve as jserve_cli  # noqa: E402
from multimodal_deepfake_detection_tpu.cli import test_visual as jtv  # noqa: E402
from multimodal_deepfake_detection_tpu.data import face_detect as jfd  # noqa: E402
from multimodal_deepfake_detection_tpu.data import native_video as jnv  # noqa: E402
from multimodal_deepfake_detection_tpu.data import video_enhanced as jve  # noqa: E402
from multimodal_deepfake_detection_tpu.models import heads as jheads  # noqa: E402
from multimodal_deepfake_detection_tpu_torch.cli import serve as tserve_cli  # noqa: E402
from multimodal_deepfake_detection_tpu_torch.cli import test_visual as ttv  # noqa: E402
from multimodal_deepfake_detection_tpu_torch.core.checkpoint import save_bundle  # noqa: E402
from multimodal_deepfake_detection_tpu_torch.data import face_detect as tfd  # noqa: E402
from multimodal_deepfake_detection_tpu_torch.data import native_video as tnv  # noqa: E402
from multimodal_deepfake_detection_tpu_torch.data import video_enhanced as tve  # noqa: E402
from multimodal_deepfake_detection_tpu_torch.models.heads import (  # noqa: E402
    ArcFace,
    XceptionLSTM,
)
from multimodal_deepfake_detection_tpu_torch.utils import jax_weights  # noqa: E402

from train_oracle import randomize_buffers  # noqa: E402

HIDDEN = 8
SCORE_TOL = 1e-4
# (name, frames, codec): MJPEG through cv2, H.264 through the libav engine
CLIPS = (("v0.avi", 6, "mjpg"), ("v1.avi", 5, "mjpg"), ("v2.mp4", 7, "h264"),
         ("v3.mp4", 4, "h264"), ("v4.avi", 3, "mjpg"), ("v5.mp4", 5, "h264"))
SPLITS = ("train", "train", "train", "dev", "test", "test")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _frames(rng, t, h=48, w=64):
    frames = (rng.random((t, h, w, 3)) * 255).astype(np.uint8)
    return np.stack([cv2.GaussianBlur(f, (7, 7), 3) for f in frames])


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    """The clips of ``CLIPS`` (H.264 only where the libav engine encodes),
    a LAV-DF metadata.json over them and each clip's frames as
    ``<file>.npy``, which the ``lavdf`` mode reads."""
    root = tmp_path_factory.mktemp("videos")
    rng = np.random.default_rng(16)
    written = []
    for name, t, codec in CLIPS:
        frames = _frames(rng, t)
        path = str(root / name)
        if codec == "h264":
            try:
                if tnv.encode_test_video(path, frames) <= 0:
                    continue
            except ImportError:
                continue
        else:
            w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10, frames.shape[2:0:-1])
            for f in frames:
                w.write(f)
            w.release()
        np.save(root / (name + ".npy"), frames)  # what the npy mode reads
        written.append(name)
    meta = [{"file": name, "split": split, "fake_periods": [[0.1, 0.4]] if i % 2 else [],
             "n_fakes": i % 2} for i, (name, split) in enumerate(zip(written, SPLITS))]
    (root / "metadata.json").write_text(json.dumps(meta))
    return root, written


def _need(videos, ext):
    if not any(n.endswith(ext) for n in videos[1]):
        pytest.skip("no libav H.264 encoder")


@pytest.mark.parametrize("shape", [(40, 60), (60, 40), (33, 33)])
def test_detectors_match_jax(shape):
    frame = np.zeros(shape + (3,), np.uint8)
    box = tfd.center_box_detector(frame)
    assert box == jfd.center_box_detector(frame)
    assert tfd.make_detector("none")(frame) == jfd.make_detector("none")(frame)
    for b in (box, (0, 0, 5, 7), (shape[1] - 3, shape[0] - 2, shape[1], shape[0])):
        np.testing.assert_array_equal(tfd.crop_with_margin(frame, b, margin=20),
                                      jfd.crop_with_margin(frame, b, margin=20))
    with pytest.raises(ValueError, match="ONNX"):
        tfd.make_detector("yunet")


@pytest.mark.parametrize("ext,size,max_frames", [
    (".avi", (32, 24), None), (".avi", None, 3), (".mp4", (32, 32), 4), (".mp4", None, None),
])
def test_decode_matches_jax(videos, ext, size, max_frames):
    """``decode_video`` (MJPEG-AVI engine, the libav engine for mp4) and the
    engines' direct entry points return JAX's frames bit for bit."""
    _need(videos, ext)
    root, names = videos
    for name in (n for n in names if n.endswith(ext)):
        path = str(root / name)
        got = tnv.decode_video(path, size=size, max_frames=max_frames)
        want = jnv.decode_video(path, size=size, max_frames=max_frames)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        if ext == ".mp4":
            np.testing.assert_array_equal(
                tnv.decode_video_av(path, size=size, max_frames=max_frames),
                jnv.decode_video_av(path, size=size, max_frames=max_frames))
        assert tnv.probe(path) == jnv.probe(path)


def test_decode_rejects_what_jax_rejects(tmp_path):
    bad = tmp_path / "x.avi"
    bad.write_bytes(b"not a riff file at all" * 10)
    npy = tmp_path / "y.npy"
    np.save(npy, np.zeros((2, 4, 4, 3), np.uint8))
    for p in (str(bad), str(npy)):
        assert tnv.decode_video(p) is None and jnv.decode_video(p) is None
        assert tnv.probe(p) is None


def test_engines_counted_and_built_outside_native(videos):
    """Each decoded clip counts under its engine; the libraries load from the
    port's ``build/``, never from ``native/``."""
    from multimodal_deepfake_detection_tpu_torch.data import native_build

    root, names = videos
    tnv.reset_engine_counts()
    for name in names:
        tnv.decode_video(str(root / name))
    n_avi = sum(n.endswith(".avi") for n in names)
    assert tnv.ENGINE_COUNTS == {"mjpeg": n_avi, "libav": len(names) - n_avi, "cv2": 0}
    assert tnv._load_lib()._name.startswith(str(native_build.BUILD_DIR))


def test_encoder_writes_what_jax_writes(tmp_path):
    """``encode_test_video`` in both packages: the same stream, decoded."""
    frames = _frames(np.random.default_rng(3), 4)
    try:
        if tnv.encode_test_video(str(tmp_path / "t.mp4"), frames) <= 0:
            pytest.skip("no libav H.264 encoder")
    except ImportError:
        pytest.skip("no libav engine")
    assert jnv.encode_test_video(str(tmp_path / "j.mp4"), frames) > 0
    np.testing.assert_array_equal(tnv.decode_video(str(tmp_path / "t.mp4")),
                                  jnv.decode_video(str(tmp_path / "j.mp4")))


def _csv_trees(root):
    """A FakeAVCeleb tree in the official schema and one in the simple
    ``path,label,split`` schema (8 real, 2 fake: the minority is drawn)."""
    os.makedirs(root / "npys")
    official = ["source,target1,method,category,type,race,gender,filename,path"]
    for i in range(8):
        np.save(root / "npys" / f"clip{i}.npy", np.full((3, 8, 8, 3), 30 * i, np.uint8))
        typ = "RealVideo-RealAudio" if i % 3 else "FakeVideo-FakeAudio"
        official.append(f"s,t,m,c,{typ},r,g,clip{i}.npy,.")
    (root / "official.csv").write_text("\n".join(official))
    simple = ["path,label,split"] + [f"clip{i % 8}.npy,{'real' if i < 8 else 'fake'},train"
                                     for i in range(10)]
    (root / "simple.csv").write_text("\n".join(simple))
    os.makedirs(root / "flat")
    for name in ("real_0", "fake_0", "fake_1"):
        np.save(root / "flat" / f"{name}.npy", np.full((2, 8, 8, 3), 200, np.uint8))


@pytest.fixture(scope="module")
def csv_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("csv")
    _csv_trees(root)
    return root


DATASET_CASES = {
    "official": dict(mode="fakeavceleb", csv="official.csv"),
    "simple": dict(mode="fakeavceleb", csv="simple.csv"),
    "sampled": dict(mode="fakeavceleb", csv="simple.csv", sample_percentage=0.5, seed=3),
    "augmented": dict(mode="fakeavceleb", csv="simple.csv", augment_minority=True, seed=5),
    "both": dict(mode="fakeavceleb", csv="simple.csv", sample_percentage=0.7,
                 augment_minority=True, seed=7),
    "flat": dict(mode="fakeavceleb"),
    "lavdf": dict(mode="lavdf"),
    "lavdf_raw": dict(mode="lavdf_raw"),
}


@pytest.mark.parametrize("case", list(DATASET_CASES))
@pytest.mark.parametrize("subset", ["train", "dev", "test"])
def test_dataset_samples_match_jax(case, subset, csv_root, videos):
    kw = dict(DATASET_CASES[case])
    mode, csv = kw.pop("mode"), kw.pop("csv", None)
    if mode.startswith("lavdf"):
        folder, kw["lavdf_json"] = str(videos[0]), str(videos[0] / "metadata.json")
    else:
        folder = str(csv_root / ("flat" if csv is None else "npys"))
        kw["csv_path"] = str(csv_root / csv) if csv else None
    got = tve.EnhancedVideoDataset(folder, mode=mode, subset=subset, **kw)
    want = jve.EnhancedVideoDataset(folder, mode=mode, subset=subset, **kw)
    assert got.samples == want.samples and got.all_labels == want.all_labels
    assert got.raw_video == want.raw_video and got.native_decode == want.native_decode


LOADER_CASES = {
    "lavdf_raw native": dict(mode="lavdf_raw", frame_size=(32, 24), max_frames=4),
    "lavdf_raw faces": dict(mode="lavdf_raw", use_face_detection=True, frame_size=(24, 24),
                            max_frames=5, num_workers=2),
    "lavdf npy": dict(mode="lavdf", max_frames=4, shuffle=True, seed=2),
    "fakeavceleb sampled": dict(mode="fakeavceleb", csv="simple.csv", sample_percentage=0.6,
                                augment_minority=True, shuffle=True, seed=4, num_workers=2,
                                buckets=(2, 3)),
}


@pytest.mark.parametrize("case", list(LOADER_CASES))
def test_loader_batches_match_jax(case, csv_root, videos):
    """Two epochs of ``get_face_dataloader`` (batch 2): batches, labels and
    lengths bit-equal to JAX's."""
    kw = dict(LOADER_CASES[case])
    mode, csv = kw.pop("mode"), kw.pop("csv", None)
    if mode.startswith("lavdf"):
        folder, kw["lavdf_json"] = str(videos[0]), str(videos[0] / "metadata.json")
    else:
        folder, kw["csv_path"] = str(csv_root / "npys"), str(csv_root / csv)
    got = tve.get_face_dataloader(folder, mode=mode, subset="train", batch_size=2, **kw)
    want = jve.get_face_dataloader(folder, mode=mode, subset="train", batch_size=2, **kw)
    for _epoch in range(2):
        pairs = list(zip(got, want))
        assert len(pairs) == len(want) > 0
        for g, w in pairs:
            for a, b in zip(g, w):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


def _bundle(path):
    model = randomize_buffers(XceptionLSTM(HIDDEN, generator=torch.Generator().manual_seed(4)), 4)
    params, state = jax_weights.xception_lstm_to_jax(model)
    arc = jax_weights.arcface_to_jax(ArcFace(HIDDEN, 2, generator=torch.Generator().manual_seed(5)))
    save_bundle(path, {"model": params, "arcface": arc, "state": state})


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bundle") / "visual.npz")
    _bundle(path)
    return path


def test_serve_cli_on_videos_matches_jax(videos, bundle, tmp_path):
    """``cli/serve.py --engine visual`` on a directory of videos: the same
    inputs in the same order, scores within 1e-4 of the JAX CLI's, and the
    port's log names the engine of each decoded clip."""
    root, names = videos
    clips = tmp_path / "clips"
    clips.mkdir()
    for name in names:
        os.symlink(root / name, clips / name)
    argv = ["--ckpt_path", bundle, "--input", str(clips), "--hidden_dim", str(HIDDEN),
            "--frame_size", "32", "--max_frames", "4", "--buckets", "4", "--batch_size",
            str(len(names)), "--compute_dtype", "float32"]
    recs = {}
    for side, main, extra in (("jax", jserve_cli.main, []),
                              ("torch", tserve_cli.main, ["--device", "cpu"])):
        out = tmp_path / f"{side}.jsonl"
        logs = []
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("MDD_NO_COMPILE_CACHE", "1")
            mp.setattr(jheads, "xception_lstm_init", _template_xception)
            main(argv + extra + ["--output", str(out)], log=logs.append)
        recs[side] = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["path"] for r in recs["torch"]] == [r["path"] for r in recs["jax"]]
    assert len(recs["torch"]) == len(names)
    np.testing.assert_allclose([r["score"] for r in recs["torch"]],
                               [r["score"] for r in recs["jax"]], rtol=0, atol=SCORE_TOL)
    n_avi = sum(n.endswith(".avi") for n in names)
    assert (f"[serve] clips decoded per engine: mjpeg {n_avi}, libav {len(names) - n_avi}, "
            "cv2 0") in logs


def _template_xception(rng, hidden_dim):
    """The shapes of JAX's ``xception_lstm_init`` without its 20 M random
    draws, ~10 s on the CPU (the CLIs' strict merge replaces every leaf)."""
    tree = jax_weights.xception_lstm_to_jax(XceptionLSTM(hidden_dim))
    return jax.tree_util.tree_map(jax.numpy.asarray, tree)


def test_visual_lavdf_raw_matches_jax(videos, bundle):
    """``test_visual --mode lavdf_raw --subset test`` in both packages: the
    same clips decoded, the metrics within 1e-4."""
    root, _ = videos
    argv = ["--mode", "lavdf_raw", "--subset", "test", "--test_folder", str(root),
            "--lavdf_json", str(root / "metadata.json"), "--ckpt_path", bundle,
            "--hidden_dim", str(HIDDEN), "--frame_size", "32,32", "--max_frames", "4",
            "--buckets", "4", "--compute_dtype", "float32"]
    results = {}
    for side, main, extra in (("jax", jtv.main, []), ("torch", ttv.main, ["--device", "cpu"])):
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("MDD_NO_COMPILE_CACHE", "1")
            mp.setattr(jtv, "xception_lstm_init", _template_xception)
            results[side] = main(argv + extra, log=lambda s: None)
    assert sorted(results["torch"]) == sorted(results["jax"])
    assert results["torch"]["total_real"] + results["torch"]["total_fake"] == 2
    for k, v in results["jax"].items():
        np.testing.assert_allclose(results["torch"][k], v, rtol=0, atol=SCORE_TOL, err_msg=k)
