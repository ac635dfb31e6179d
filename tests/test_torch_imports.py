"""The port imports no JAX and nothing of the JAX package, its kernels
never fall back silently, and each launches on its tensor's device.

No JAX needed: these run wherever the port runs.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from multimodal_deepfake_detection_tpu_torch.core.checkpoint import save_bundle
from multimodal_deepfake_detection_tpu_torch.models.au_face import AUFaceDetector
from multimodal_deepfake_detection_tpu_torch.models.heads import XceptionLSTM
from multimodal_deepfake_detection_tpu_torch.models.resnet_lstm import AUPatchClassifier
from multimodal_deepfake_detection_tpu_torch.models.serve import AudioScorer
from multimodal_deepfake_detection_tpu_torch.ops.kernels import _build
from multimodal_deepfake_detection_tpu_torch.ops.kernels import dw_w8a8 as dw_w8a8_mod
from multimodal_deepfake_detection_tpu_torch.ops.kernels import entry_block as entry_block_mod
from multimodal_deepfake_detection_tpu_torch.ops.kernels import entry_pair as entry_pair_mod
from multimodal_deepfake_detection_tpu_torch.ops.kernels import middle_block as middle_block_mod
from multimodal_deepfake_detection_tpu_torch.ops.kernels import middle_block_w8 as k2_mod
from multimodal_deepfake_detection_tpu_torch.ops.kernels import sepconv_unit as sepconv_unit_mod
from multimodal_deepfake_detection_tpu_torch.ops.kernels.dw_w8a8 import dw_w8a8
from multimodal_deepfake_detection_tpu_torch.ops.kernels.entry_block import entry_block
from multimodal_deepfake_detection_tpu_torch.ops.kernels.entry_pair import entry_pair
from multimodal_deepfake_detection_tpu_torch.ops.kernels.middle_block import (
    middle_block,
    middle_block_bf16taps,
)
from multimodal_deepfake_detection_tpu_torch.ops.kernels.middle_block_w8 import middle_block_w8
from multimodal_deepfake_detection_tpu_torch.ops.kernels.sepconv_unit import sepconv_unit
from multimodal_deepfake_detection_tpu_torch.utils.jax_weights import (
    au_face_to_jax,
    au_patch_to_jax,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKER = """
import sys

class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "optax"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, _Block())
"""
_NO_JAX_LOADED = """
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "optax", "multimodal_deepfake_detection_tpu"))
assert not loaded, loaded
print("ok")
"""

_BLOCKED_IMPORT = _BLOCKER + """
import multimodal_deepfake_detection_tpu_torch.models.serve
import multimodal_deepfake_detection_tpu_torch.cli.serve
import multimodal_deepfake_detection_tpu_torch.models.resnet
import multimodal_deepfake_detection_tpu_torch.models.resnet_lstm
import multimodal_deepfake_detection_tpu_torch.models.au_face
import multimodal_deepfake_detection_tpu_torch.models.fold
import multimodal_deepfake_detection_tpu_torch.ops.lstm
import multimodal_deepfake_detection_tpu_torch.utils.jax_weights
import multimodal_deepfake_detection_tpu_torch.ops.kernels.middle_block
import multimodal_deepfake_detection_tpu_torch.ops.kernels.middle_block_w8
import multimodal_deepfake_detection_tpu_torch.ops.kernels.dw_w8a8
import multimodal_deepfake_detection_tpu_torch.ops.kernels.entry_block
import multimodal_deepfake_detection_tpu_torch.ops.kernels.entry_pair
import multimodal_deepfake_detection_tpu_torch.ops.kernels.sepconv_unit
import multimodal_deepfake_detection_tpu_torch.ops.quant
import multimodal_deepfake_detection_tpu_torch.models.quant
import multimodal_deepfake_detection_tpu_torch.models.heads
import multimodal_deepfake_detection_tpu_torch.ops.mfcc
import multimodal_deepfake_detection_tpu_torch.core.precision
import multimodal_deepfake_detection_tpu_torch.core.config
import multimodal_deepfake_detection_tpu_torch.core.checkpoint
import multimodal_deepfake_detection_tpu_torch.models.losses
import multimodal_deepfake_detection_tpu_torch.train
import multimodal_deepfake_detection_tpu_torch.train.steps
import multimodal_deepfake_detection_tpu_torch.train.loop
import multimodal_deepfake_detection_tpu_torch.train.feature_cache
import multimodal_deepfake_detection_tpu_torch.metrics.roc
import multimodal_deepfake_detection_tpu_torch.data.datasets
import multimodal_deepfake_detection_tpu_torch.data.loader
import multimodal_deepfake_detection_tpu_torch.data.synthetic
import multimodal_deepfake_detection_tpu_torch.cli.train_visual
import multimodal_deepfake_detection_tpu_torch.cli.train_audio
import multimodal_deepfake_detection_tpu_torch.cli.train_au_patch
import multimodal_deepfake_detection_tpu_torch.cli.train_au_face
import multimodal_deepfake_detection_tpu_torch.data.au_patches
import multimodal_deepfake_detection_tpu_torch.data.metadata
import multimodal_deepfake_detection_tpu_torch.ops.kernels.library
import multimodal_deepfake_detection_tpu_torch.models.export
import multimodal_deepfake_detection_tpu_torch.models.artifact
import multimodal_deepfake_detection_tpu_torch.serving
import multimodal_deepfake_detection_tpu_torch.serving.batcher
import multimodal_deepfake_detection_tpu_torch.serving.daemon
import multimodal_deepfake_detection_tpu_torch.cli.export_serving
import multimodal_deepfake_detection_tpu_torch.cli.serve_daemon
import multimodal_deepfake_detection_tpu_torch.cli.test_visual
import multimodal_deepfake_detection_tpu_torch.cli.test_audio
import multimodal_deepfake_detection_tpu_torch.cli.test_av_fused
import multimodal_deepfake_detection_tpu_torch.cli.test_au_patch
import multimodal_deepfake_detection_tpu_torch.cli.test_au_face
import multimodal_deepfake_detection_tpu_torch.utils.saliency
import multimodal_deepfake_detection_tpu_torch.utils.visualize
import multimodal_deepfake_detection_tpu_torch.utils.metric_logger
import multimodal_deepfake_detection_tpu_torch.utils.profiling
import multimodal_deepfake_detection_tpu_torch.data.face_detect
import multimodal_deepfake_detection_tpu_torch.data.native_build
import multimodal_deepfake_detection_tpu_torch.data.native_video
import multimodal_deepfake_detection_tpu_torch.data.video_enhanced
import multimodal_deepfake_detection_tpu_torch.data.native_loader
import multimodal_deepfake_detection_tpu_torch.data.preprocess
import multimodal_deepfake_detection_tpu_torch.utils.torch_port
import multimodal_deepfake_detection_tpu_torch.cli.import_torch
import multimodal_deepfake_detection_tpu_torch.cli.preprocess_faces
import multimodal_deepfake_detection_tpu_torch.cli.preprocess_audio
import chip_smoke
from multimodal_deepfake_detection_tpu_torch.cli.serve import Config, build_engine
for engine in ("au_face", "au_patch"):  # the CLI engines, built on a bundle of the port's own
    build_engine(Config(engine=engine, ckpt_path=sys.argv[1] + "/" + engine + ".npz",
                        device="cpu", lstm_hidden=4, patch_hidden=8, patch_lstm_hidden=4))
from multimodal_deepfake_detection_tpu_torch.cli import train_visual
from multimodal_deepfake_detection_tpu_torch.data.synthetic import make_face_npy_tree
tree = make_face_npy_tree(sys.argv[1] + "/faces", n_per_class=1, frames=2, size=32)
train_visual.main(["--train_folder", tree + "/train", "--eval_folder", tree + "/eval",
                   "--checkpoint_dir", sys.argv[1] + "/ck", "--epochs", "1", "--hidden_dim", "4",
                   "--batch_size", "2", "--buckets", "2", "--device", "cpu"], log=lambda s: None)
from multimodal_deepfake_detection_tpu_torch.cli import train_au_face, train_au_patch, train_audio
from multimodal_deepfake_detection_tpu_torch.data import synthetic
root = sys.argv[1]
synthetic.make_au_patch_tree(root + "/patches", n_per_class=1, frames=2, n_aus=2, size=16)
synthetic.make_joint_tree(root + "/jv", root + "/ja", n_per_class=1, frames=2, n_aus=2,
                          face_size=16, patch_size=16)
synthetic.make_audio_npy_tree(root + "/mfcc", n_per_class=1, frames=3)
common = ["--epochs", "1", "--device", "cpu", "--jsonl_log"]
train_au_patch.main(["--data_root", root + "/patches", "--checkpoint_dir", root + "/cp",
                     "--hidden_dim", "8", "--lstm_hidden", "4", "--image_size", "16",
                     "--max_frames", "2", "--max_aus", "2"] + common + [root + "/p.jsonl"],
                    log=lambda s: None)
train_au_face.main(["--video_root", root + "/jv", "--au_root", root + "/ja", "--checkpoint_dir",
                    root + "/cf", "--lstm_hidden", "4", "--face_dim", "8", "--au_dim", "8",
                    "--embed_dim", "8", "--num_aus", "2", "--image_size", "16", "--max_frames",
                    "2"] + common + [root + "/f.jsonl"], log=lambda s: None)
train_audio.main(["--train_folder", root + "/mfcc/train", "--eval_folder", root + "/mfcc/eval",
                  "--checkpoint_dir", root + "/ca", "--hidden_dim", "4", "--batch_size", "2",
                  "--buckets", "3", "--eval_every", "1"] + common + [root + "/a.jsonl"],
                  log=lambda s: None)
import json
for name in ("p", "f", "a"):  # the trainers' metric loggers
    assert [json.loads(x)["event"] for x in open(root + "/" + name + ".jsonl")] == [
        "run_start", "epoch"]
from multimodal_deepfake_detection_tpu_torch.cli import test_au_patch
report = []  # an evaluation CLI, to its report, on the bundle of the port's own
results = test_au_patch.main(["--data_root", root + "/patches", "--ckpt_path",
                              root + "/au_patch.npz", "--hidden_dim", "8", "--lstm_hidden", "4",
                              "--image_size", "16", "--max_frames", "2", "--max_aus", "2",
                              "--device", "cpu"], log=report.append)
assert report[0].startswith("AUC: ") and report[1].startswith("[thr=0.5] Acc=")
assert sorted(results)[:3] == ["AUC", "EER", "pAUC"]
import numpy as np
import torch
from multimodal_deepfake_detection_tpu_torch.data import native_loader, native_video
from multimodal_deepfake_detection_tpu_torch.data.datasets import NpyFolderDataset
from multimodal_deepfake_detection_tpu_torch.data.loader import DataLoader
if native_loader.native_available():  # the C++ collate of the MFCC tree, as the Python loader
    ds = NpyFolderDataset(root + "/mfcc/train", kind="audio")
    native = next(iter(native_loader.make_native_loader(ds, 2, buckets=(3,), prefetch=0)))
    python = next(iter(DataLoader(ds, 2, buckets=(3,), prefetch=0)))
    assert all(np.array_equal(a, b) for a, b in zip(native, python))
try:
    import cv2
except ImportError:
    cv2 = None
if cv2 is not None and native_video.native_video_available():  # a native decode of an MJPEG clip
    w = cv2.VideoWriter(root + "/c.avi", cv2.VideoWriter_fourcc(*"MJPG"), 10, (16, 8))
    for i in range(3):
        w.write(np.full((8, 16, 3), 40 * i, np.uint8))
    w.release()
    assert native_video.decode_video(root + "/c.avi", size=(8, 8)).shape == (3, 8, 8, 3)
    assert native_video.ENGINE_COUNTS["mjpeg"] == 1
from multimodal_deepfake_detection_tpu_torch.cli import import_torch
from multimodal_deepfake_detection_tpu_torch.core.checkpoint import (_flatten_with_paths,
                                                                     load_bundle)
from multimodal_deepfake_detection_tpu_torch.models.heads import ArcFace, XceptionLSTM
from multimodal_deepfake_detection_tpu_torch.utils.jax_weights import (arcface_to_jax,
                                                                       xception_lstm_to_jax)
params, state = xception_lstm_to_jax(XceptionLSTM(4, generator=torch.Generator().manual_seed(1)))
trees = {"model": params, "state": state, "arcface": arcface_to_jax(ArcFace(4, 2))}
torch.save(chip_smoke.reference_state_dict(torch, trees), root + "/ref.pth")
import_torch.main(["--src", root + "/ref.pth", "--dst", root + "/imported.npz"],
                  log=lambda s: None)  # a reference .pth back to the bundle it came from
got, want = _flatten_with_paths(load_bundle(root + "/imported.npz")), _flatten_with_paths(trees)
assert sorted(got) == sorted(want) and all(np.array_equal(got[k], want[k]) for k in want)
""" + _NO_JAX_LOADED

# one tiny export under the blocker, in a process of its own: beside the
# four trainers it pushed the import check past its hang guard when six
# test workers loaded the machine
_BLOCKED_EXPORT = _BLOCKER + """
import numpy as np
from multimodal_deepfake_detection_tpu_torch.cli.serve import Config, build_engine
from multimodal_deepfake_detection_tpu_torch.models.artifact import ArtifactScorer
from multimodal_deepfake_detection_tpu_torch.models.export import export_au_patch
scorer = build_engine(Config(engine="au_patch", ckpt_path=sys.argv[1] + "/au_patch.npz",
                             device="cpu", patch_hidden=8, patch_lstm_hidden=4))
patches = np.zeros((1, 2, 2, 8, 8, 3), np.uint8)
assert ArtifactScorer(export_au_patch(scorer, 2, 2, (8, 8), batch=1)).score(patches) == \
    scorer.score(patches)
""" + _NO_JAX_LOADED


def _run_blocked(script: str, tmp_path) -> None:
    # one intra-op thread: beside five other test workers, one per core
    # oversubscribes the cores and the run slows several times
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", script, str(tmp_path)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_port_imports_without_jax(tmp_path):
    """Every module of the port imports, the AU engines of its CLI build
    from bundles, ``train_visual``, ``train_au_patch``, ``train_au_face``
    and ``train_audio`` each train an epoch (the last three with
    ``--jsonl_log``), ``test_au_patch`` evaluates the AU-patch bundle to
    its report, the native collate batches the MFCC tree as the Python
    loader does, the native engine decodes an MJPEG clip (where cv2 writes
    one) and ``import_torch`` turns a reference ``.pth`` back into the
    bundle it came from, with JAX blocked."""
    g = torch.Generator().manual_seed(0)
    save_bundle(str(tmp_path / "au_face.npz"),
                dict(zip(("model", "state"), au_face_to_jax(AUFaceDetector(4, generator=g)))))
    save_bundle(str(tmp_path / "au_patch.npz"), dict(zip(("model", "state"), au_patch_to_jax(
        AUPatchClassifier(8, 4, generator=g)))))
    _run_blocked(_BLOCKED_IMPORT, tmp_path)


def test_port_exports_without_jax(tmp_path):
    """With JAX blocked, the CLI's AU-patch engine exports a program
    (``models/export.py``) that replays through ``ArtifactScorer`` to its
    live scores."""
    save_bundle(str(tmp_path / "au_patch.npz"), dict(zip(("model", "state"), au_patch_to_jax(
        AUPatchClassifier(8, 4, generator=torch.Generator().manual_seed(0))))))
    _run_blocked(_BLOCKED_EXPORT, tmp_path)


def test_loader_raises_without_nvcc(monkeypatch):
    """No stub and no fallback: without the CUDA toolkit the loader raises."""
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    _build.load_library.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load_library("middle_block")


@pytest.mark.parametrize("name", ["middle_block_w8", "dw_w8a8", "entry_block", "entry_pair",
                                  "sepconv_unit"])
def test_int8_kernel_loaders_raise_without_nvcc(monkeypatch, name):
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    _build.load_library.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load_library(name)


def test_non_cpu_tensor_never_takes_the_plain_version():
    """Off the CPU the wrapper launches the kernel or raises. A meta tensor
    must raise rather than run the plain version: K1 with either tap order,
    K4 with each switch setting, K5."""
    C = 16
    x = torch.empty((1, 2, 2, C), device="meta")
    dw = torch.zeros((3, 9, C))
    pw = torch.zeros((3, C, C), dtype=torch.bfloat16)
    b = torch.zeros((3, C))
    pw2, taps, vec = torch.zeros((C, C), dtype=torch.bfloat16), torch.zeros((9, C)), torch.zeros(C)
    calls = [
        (middle_block, middle_block, (x, dw, pw, b), {}),
        (middle_block_bf16taps, middle_block, (x, dw, pw, b), {"taps": "bf16"}),
        (middle_block_bf16taps, middle_block_bf16taps, (x, dw, pw, b), {}),
        (sepconv_unit, sepconv_unit, (x, taps, pw2, vec),
         {"leading_relu": False, "trailing_relu": True}),
    ] + [
        (entry_pair, entry_pair, (x, taps, pw2, vec, taps, pw2, vec),
         {"leading_relu0": True, "col_sums": col, "mid_fp32": mid})
        for col, mid in ((True, False), (False, True), (False, False))
    ]
    for counter, fn, args, kw in calls:
        before = counter.launches
        with pytest.raises(ValueError, match="CUDA"):
            fn(*args, **kw)
        assert counter.launches == before


def _meta_args(name):
    """Well-formed operands of a kernel's wrapper, ``x`` on the meta device."""
    C = 16
    x = torch.empty((1, 2, 2, C), device="meta")
    if name == "entry_block":
        pw, b = torch.zeros((C, C), dtype=torch.bfloat16), torch.zeros(C)
        return entry_block, (x, torch.zeros((9, C)), pw, b, torch.zeros((9, C)), pw, b, pw, b)
    if name == "middle_block_w8":
        return middle_block_w8, (x, torch.zeros((3, 9, C)), torch.zeros((3, C, 64), dtype=torch.int8),
                                 torch.ones((3, C)), torch.ones((3, C)), torch.ones(3),
                                 torch.zeros((3, C)))
    return dw_w8a8, (x, torch.zeros((C, 1, 3, 3), dtype=torch.int8), torch.ones(C), torch.ones(C),
                     torch.bfloat16)


@pytest.mark.parametrize("name", ["middle_block_w8", "dw_w8a8", "entry_block"])
def test_int8_kernels_never_take_the_plain_version_off_the_cpu(name):
    fn, args = _meta_args(name)
    before = fn.launches
    with pytest.raises(ValueError, match="CUDA"):
        fn(*args, **({"leading_relu0": True} if name == "entry_block" else {}))
    assert fn.launches == before


@pytest.mark.parametrize("route,counter", [
    ({}, middle_block), ({"fuse_entry": True}, entry_block), ({"entry_pair": True}, entry_pair),
    ({"middle_taps": "bf16"}, middle_block_bf16taps),
])
def test_audio_path_never_takes_the_plain_version_off_the_cpu(route, counter):
    """The audio engine with kernels on, on a device that is neither the CPU
    nor CUDA: the MFCC frontend and the stem run, then the first kernel's
    wrapper raises instead of running its plain version."""
    model = XceptionLSTM(8, generator=torch.Generator().manual_seed(0))
    scorer = AudioScorer(model, device="meta", use_kernels=True, **route)
    before = counter.launches
    with pytest.raises(ValueError, match="CUDA"):
        scorer.score(np.zeros((1, 800), np.float32))
    assert counter.launches == before


class _FakeCuda:
    """Stands in for ``torch.cuda.device`` and ``current_stream`` and for a
    kernel library: records the device current at each C call."""

    def __init__(self, err=0):
        self.current, self.calls, self.err = "the default device", [], err

    def device(self, dev):
        fake = self

        class Guard:
            def __enter__(self):
                self.before, fake.current = fake.current, dev

            def __exit__(self, *exc):
                fake.current = self.before
        return Guard()

    def current_stream(self, dev):
        return type("Stream", (), {"cuda_stream": f"stream of {dev}"})()

    def __getattr__(self, entry):  # the library's C entry points
        if entry == "mdfd_error_string":
            return lambda err: b"boom"
        return lambda *args: self.calls.append((entry, self.current, args[-1])) or self.err


def _guarded_call(name):
    """(module, wrapper, args, kw) with ``x`` on the meta device."""
    C, meta = 16, torch.empty((1, 2, 2, 16), device="meta")
    pw, vec, taps = torch.zeros((C, C), dtype=torch.bfloat16), torch.zeros(C), torch.zeros((9, C))
    if name == "middle_block":
        return (middle_block_mod, middle_block,
                (meta, torch.zeros((3, 9, C)), torch.zeros((3, C, C), dtype=torch.bfloat16),
                 torch.zeros((3, C))), {})
    if name == "entry_pair":
        return entry_pair_mod, entry_pair, (meta, taps, pw, vec, taps, pw, vec), {
            "leading_relu0": True}
    if name == "sepconv_unit":
        return sepconv_unit_mod, sepconv_unit, (meta, taps, pw, vec), {
            "leading_relu": False, "trailing_relu": True}
    fn, args = _meta_args(name)
    mod = {"middle_block_w8": k2_mod, "dw_w8a8": dw_w8a8_mod, "entry_block": entry_block_mod}[name]
    return mod, fn, args, {"leading_relu0": True} if name == "entry_block" else {}


KERNEL_MODULES = ["middle_block", "middle_block_w8", "dw_w8a8", "entry_block", "entry_pair",
                  "sepconv_unit"]


@pytest.mark.parametrize("name", KERNEL_MODULES)
def test_kernel_launches_on_its_tensors_device(name, monkeypatch):
    """Every wrapper launches through ``_build.launch``: its C call runs with
    x's device current (``torch.cuda.device``) and gets x's device's stream,
    and the default device comes back after. (One GPU here at most: what a
    second device does is not run.)"""
    mod, fn, args, kw = _guarded_call(name)
    fake = _FakeCuda()
    monkeypatch.setattr(torch.cuda, "device", fake.device)
    monkeypatch.setattr(torch.cuda, "current_stream", fake.current_stream)
    monkeypatch.setattr(mod, "_lib", lambda: fake)
    monkeypatch.setattr(mod, "check_pair" if name == "entry_pair" else "_check", lambda *a: None)
    monkeypatch.setattr(fn, "launches", 0)
    fn(*args, **kw)
    assert fake.calls == [(f"mdfd_{name}", args[0].device, f"stream of {args[0].device}")]
    assert fake.current == "the default device" and fn.launches == 1


def test_kernel_error_raises_with_the_library_message(monkeypatch):
    mod, fn, args, kw = _guarded_call("sepconv_unit")
    fake = _FakeCuda(err=7)
    monkeypatch.setattr(torch.cuda, "device", fake.device)
    monkeypatch.setattr(torch.cuda, "current_stream", fake.current_stream)
    monkeypatch.setattr(mod, "_lib", lambda: fake)
    monkeypatch.setattr(mod, "_check", lambda *a: None)
    monkeypatch.setattr(fn, "launches", 0)
    with pytest.raises(RuntimeError, match="sepconv_unit kernel failed: boom"):
        fn(*args, **kw)
    assert fn.launches == 0 and fake.current == "the default device"
