"""The port's preprocessing and checkpoint-import CLIs against the JAX
package's, on the CPU.

- ``preprocess_faces`` (UADFV face crops, FakeAVCeleb frames) on MJPEG clips
  written here with cv2: the same files written, each ``.npy`` bit-equal;
- ``preprocess_audio`` on seeded ``.wav`` files: the same files; the MFCC
  (the port's ``ops/mfcc.py`` against JAX's) at the ``mfcc`` bar of
  ``tests/test_torch_audio.py`` (atol 2e-3, rtol 1e-5); the 16 kHz mono
  loading bit-equal;
- ``import_torch`` on reference-layout ``.pth`` files of the four flavours
  (``tests/torch_mirror.py``): the bundles equal to JAX's array for array,
  and the port's Xception forward on the imported weights against the
  mirror's (rtol 1e-3 / atol 2e-4, the bar of ``tests/test_xception.py``).

The module skips without cv2, as the JAX tests do.
"""
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
cv2 = pytest.importorskip("cv2")
import torch  # noqa: E402
from scipy.io import wavfile  # noqa: E402

from multimodal_deepfake_detection_tpu.cli import import_torch as jimport  # noqa: E402
from multimodal_deepfake_detection_tpu.cli import preprocess_audio as jpa  # noqa: E402
from multimodal_deepfake_detection_tpu.cli import preprocess_faces as jpf  # noqa: E402
from multimodal_deepfake_detection_tpu.data import preprocess as jpre  # noqa: E402
from multimodal_deepfake_detection_tpu_torch.cli import import_torch as timport  # noqa: E402
from multimodal_deepfake_detection_tpu_torch.cli import preprocess_audio as tpa  # noqa: E402
from multimodal_deepfake_detection_tpu_torch.cli import preprocess_faces as tpf  # noqa: E402
from multimodal_deepfake_detection_tpu_torch.core.checkpoint import (  # noqa: E402
    _flatten_with_paths,
    load_bundle,
)
from multimodal_deepfake_detection_tpu_torch.data import preprocess as tpre  # noqa: E402
from multimodal_deepfake_detection_tpu_torch.models.heads import (  # noqa: E402
    xception_lstm_head_apply,
)
from multimodal_deepfake_detection_tpu_torch.utils import jax_weights  # noqa: E402

from torch_mirror import MirrorXception  # noqa: E402

MFCC_TOL = dict(atol=2e-3, rtol=1e-5)
HIDDEN = 8


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _write_video(path, n_frames, seed, size=40):
    rng = np.random.default_rng(seed)
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10, (size + 8, size))
    for _ in range(n_frames):
        w.write(cv2.GaussianBlur(rng.integers(0, 256, (size, size + 8, 3), np.uint8), (5, 5), 2))
    w.release()


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    """A UADFV tree (12-frame videos per class and a 3-frame one) and a
    FakeAVCeleb tree (two subfolders of three 5-frame videos per class)."""
    root = tmp_path_factory.mktemp("raw")
    for i, (label, name, n) in enumerate((("real", "vid0", 12), ("fake", "vid0", 12),
                                          ("fake", "vid1", 11), ("real", "short", 3))):
        os.makedirs(root / "uadfv" / label, exist_ok=True)
        _write_video(str(root / "uadfv" / label / f"{name}.avi"), n, i)
    for label in ("real", "fake"):
        for sub in ("id0", "id1"):
            os.makedirs(root / "favc" / label / sub)
            for k in range(3):
                _write_video(str(root / "favc" / label / sub / f"c{k}.avi"), 5, 10 + k)
    return root


def _tree(root):
    """{relative path: array} of an output tree."""
    return {os.path.relpath(os.path.join(d, f), root): np.load(os.path.join(d, f))
            for d, _, fs in os.walk(root) for f in fs}


def _assert_trees_equal(got_root, want_root):
    got, want = _tree(got_root), _tree(want_root)
    assert sorted(got) == sorted(want) and got
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("detector", ["center", "none"])
def test_uadfv_faces_match_jax(raw, tmp_path, detector):
    """Small splits (6/2/2): the same videos kept, the short one skipped,
    the crops bit-equal."""
    kw = dict(detector=detector, size=32, splits=(("train", 6), ("eval", 2), ("test", 2)))
    tlogs, jlogs = [], []
    got = tpre.process_uadfv_faces(str(raw / "uadfv"), str(tmp_path / "t"), log=tlogs.append, **kw)
    want = jpre.process_uadfv_faces(str(raw / "uadfv"), str(tmp_path / "j"), log=jlogs.append,
                                    **kw)
    assert got == want == ["fake_vid0", "fake_vid1", "real_vid0"] and tlogs == jlogs
    _assert_trees_equal(tmp_path / "t", tmp_path / "j")


@pytest.mark.parametrize("argv", [
    ["--mode", "uadfv", "--size", "32"],  # the default 100/20/20 splits: every video skipped
    ["--mode", "fakeavceleb", "--size", "32", "--seed", "3"],
    ["--mode", "fakeavceleb", "--max_frames", "3", "--size", "24"],
])
def test_preprocess_faces_cli_matches_jax(raw, tmp_path, monkeypatch, argv):
    monkeypatch.setenv("MDD_NO_COMPILE_CACHE", "1")
    src = raw / ("uadfv" if "uadfv" in argv else "favc")
    logs = {"t": [], "j": []}
    written = {side: main(["--dataset_root", str(src), "--out_root", str(tmp_path / side)]
                          + argv, log=logs[side].append)
               for side, main in (("t", tpf.main), ("j", jpf.main))}
    assert written["t"] == written["j"]
    assert [line.replace(str(tmp_path / "t"), "") for line in logs["t"]] == \
        [line.replace(str(tmp_path / "j"), "") for line in logs["j"]]
    if written["j"]:
        _assert_trees_equal(tmp_path / "t", tmp_path / "j")
    else:
        assert any("skip" in line for line in logs["t"])


@pytest.mark.parametrize("rate,channels,dtype", [
    (16000, 1, np.int16), (44100, 2, np.int16), (22050, 1, np.float32),
])
def test_wav_loading_matches_jax(tmp_path, rate, channels, dtype):
    rng = np.random.default_rng(rate)
    data = rng.normal(0, 0.1, (int(0.3 * rate), channels)).squeeze()
    data = (data * 32767).astype(dtype) if dtype == np.int16 else data.astype(dtype)
    path = str(tmp_path / "a.wav")
    wavfile.write(path, rate, data)
    got, want = tpre._load_wav_16k_mono(path), jpre._load_wav_16k_mono(path)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def wav_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("wav")
    rng = np.random.default_rng(0)
    for label in ("real", "fake"):
        os.makedirs(root / label / "spk0")
        for name, secs in (("clip", 1.8), ("spk0/long", 2.2), ("short", 1.0)):
            wav = (rng.normal(0, 0.1, int(secs * 16000)) * 32767).astype(np.int16)
            wavfile.write(str(root / label / f"{name}.wav"), 16000, wav)
    return root


def test_preprocess_audio_cli_matches_jax(wav_root, tmp_path, monkeypatch):
    """The same clips written (the 1 s ones skipped), each split's MFCC at
    the bar."""
    monkeypatch.setenv("MDD_NO_COMPILE_CACHE", "1")
    logs = {"t": [], "j": []}
    written = {side: main(["--dataset_root", str(wav_root), "--out_root", str(tmp_path / side),
                           "--train_frames", "100"] + extra, log=logs[side].append)
               for side, main, extra in (("t", tpa.main, ["--device", "cpu"]),
                                         ("j", jpa.main, []))}
    assert written["t"] == written["j"] == ["fake_clip", "fake_spk0_long", "real_clip",
                                            "real_spk0_long"]
    assert [line.replace(str(tmp_path / "t"), "") for line in logs["t"]] == \
        [line.replace(str(tmp_path / "j"), "") for line in logs["j"]]
    got, want = _tree(tmp_path / "t"), _tree(tmp_path / "j")
    assert sorted(got) == sorted(want) and len(got) == 12
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype == np.float32
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **MFCC_TOL)


def test_preprocess_audio_defaults_to_cuda_and_raises_without_it(wav_root, tmp_path,
                                                                 monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tpa.Config().device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpa.main(["--dataset_root", str(wav_root), "--out_root", str(tmp_path)])


class _MirrorLSTMHead(torch.nn.Module):
    """The reference XceptionLSTMV layout: feature_extractor, lstm, fc_layers
    (Linear at slots 0, 3, 6, 9), fc_out."""

    def __init__(self, hidden=HIDDEN):
        super().__init__()
        self.feature_extractor = MirrorXception(num_classes=None)
        self.lstm = torch.nn.LSTM(2048, hidden, batch_first=True)
        layers = []
        for a, b in zip([hidden, 1024, 1024, 1024], [1024] * 4):
            layers += [torch.nn.Linear(a, b), torch.nn.ReLU(), torch.nn.Dropout(0.3)]
        self.fc_layers = torch.nn.Sequential(*layers)
        self.fc_out = torch.nn.Linear(1024, 1)


@pytest.fixture(scope="module")
def mirror():
    """A seeded reference-layout XceptionLSTMV with random BN statistics."""
    torch.manual_seed(0)
    m = _MirrorLSTMHead().eval()
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.copy_(0.1 * torch.randn(mod.running_mean.shape, generator=g))
                mod.running_var.copy_(0.5 + torch.rand(mod.running_var.shape, generator=g))
    return m


def _plain_sd(mirror):
    """The backbone as a plain Xception state_dict with a 5-class fc."""
    sd = {k[len("feature_extractor."):]: v for k, v in mirror.state_dict().items()
          if k.startswith("feature_extractor.")}
    g = torch.Generator().manual_seed(2)
    sd["fc.weight"], sd["fc.bias"] = torch.randn(5, 2048, generator=g) * 0.02, torch.zeros(5)
    return sd


def _import_both(tmp_path, raw_obj, argv=()):
    src = str(tmp_path / "in.pth")
    torch.save(raw_obj, src)
    out = {}
    for side, main in (("t", timport.main), ("j", jimport.main)):
        logs = []
        main(["--src", src, "--dst", str(tmp_path / f"{side}.npz")] + list(argv),
             log=logs.append)
        out[side] = (load_bundle(str(tmp_path / f"{side}.npz")), logs[0])
    got, want = _flatten_with_paths(out["t"][0]), _flatten_with_paths(out["j"][0])
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert out["t"][1] == out["j"][1]  # the detected flavour
    return out["t"][0]


def test_import_plain_xception_matches_jax(mirror, tmp_path):
    """A plain Xception state_dict with fc: the bundle equals JAX's, and the
    port's Xception on it gives the mirror's logits."""
    sd = _plain_sd(mirror)
    bundle = _import_both(tmp_path, sd)
    model = jax_weights.xception_from_jax(bundle["model"], bundle["state"]).eval()
    x = torch.randn(1, 3, 64, 64, generator=torch.Generator().manual_seed(3))
    ref_net = MirrorXception(num_classes=5).eval()
    ref_net.load_state_dict(sd)
    with torch.no_grad():
        ref = ref_net(x).numpy()
        got = model(x.permute(0, 2, 3, 1)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=2e-4)


@pytest.mark.parametrize("flavour", ["state_dict", "data_parallel"])
def test_import_xception_lstm_matches_jax(mirror, tmp_path, flavour):
    """An XceptionLSTMV ``state_dict``, and a ``{model, arcface, embed}``
    dict of ``module.``-prefixed (DataParallel) ``state_dict``s: bundles
    equal to JAX's; the port's head on the imported weights gives the
    mirror's outputs."""
    sd = mirror.state_dict()
    g = torch.Generator().manual_seed(4)
    arc = {"weight": torch.randn(2, HIDDEN, generator=g)}
    embed = torch.nn.Sequential(torch.nn.Linear(32, 16), torch.nn.ReLU(), torch.nn.Dropout(0.2),
                                torch.nn.Linear(16, 8)).state_dict()
    wrap = lambda d: {f"module.{k}": v for k, v in d.items()}  # noqa: E731
    raw_obj = sd if flavour == "state_dict" else {
        "model": wrap(sd), "arcface": wrap(arc), "embed": wrap(embed)}
    bundle = _import_both(tmp_path, raw_obj)
    if flavour == "state_dict":
        assert sorted(bundle) == ["model", "state"]
        return
    np.testing.assert_array_equal(bundle["arcface"]["w"], arc["weight"].numpy())
    model = jax_weights.xception_lstm_from_jax(bundle["model"], bundle["state"]).eval()
    feats = torch.randn(2, 3, 2048, generator=g)
    with torch.no_grad():
        out, _ = mirror.lstm(feats)
        ref = torch.sigmoid(mirror.fc_out(mirror.fc_layers(out[:, -1]))).numpy()
        got = xception_lstm_head_apply(model, feats).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
