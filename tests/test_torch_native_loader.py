"""The port's native npy collate against the JAX package's, on the CPU.

Both packages bind ``native/npy_collate.cc`` through ctypes (the port
builds it into its ``build/``, JAX into ``native/``): ``npy_shape``,
``native_collate_paths`` and ``make_native_loader`` are held bit-equal to
JAX's on face (uint8) and MFCC (float32) trees, and the native audio batches
bit-equal to the port's Python ``DataLoader``; the face batches, whose
uint8 -> f32 scale is ``* (1/255)`` in C and ``/ 255`` in numpy, within one
ulp. Skips where the JAX tests skip: without a C++ toolchain.
"""
import os

import numpy as np
import pytest

pytest.importorskip("jax")
from multimodal_deepfake_detection_tpu.data import native_loader as jnl  # noqa: E402
from multimodal_deepfake_detection_tpu_torch.data import native_build  # noqa: E402
from multimodal_deepfake_detection_tpu_torch.data import native_loader as tnl  # noqa: E402
from multimodal_deepfake_detection_tpu_torch.data.datasets import NpyFolderDataset  # noqa: E402
from multimodal_deepfake_detection_tpu_torch.data.loader import DataLoader  # noqa: E402
from multimodal_deepfake_detection_tpu_torch.data.synthetic import (  # noqa: E402
    make_audio_npy_tree,
    make_face_npy_tree,
)

pytestmark = pytest.mark.skipif(not (tnl.native_available() and jnl.native_available()),
                                reason="no C++ toolchain")


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("collate")
    face = make_face_npy_tree(str(root / "faces"), n_per_class=3, frames=5, size=24, seed=3)
    audio = make_audio_npy_tree(str(root / "audio"), n_per_class=3, frames=9, seed=4)
    # ragged lengths: clips cut to 2..5 steps
    for i, f in enumerate(sorted(os.listdir(face + "/train"))):
        path = os.path.join(face, "train", f)
        np.save(path, np.load(path)[: 2 + i % 4])
    for i, f in enumerate(sorted(os.listdir(audio + "/train"))):
        path = os.path.join(audio, "train", f)
        np.save(path, np.load(path)[: 5 + i % 5])
    return {"video": face + "/train", "audio": audio + "/train"}


def _assert_batches_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["video", "audio"])
def test_npy_shape_matches_jax(trees, kind):
    ds = NpyFolderDataset(trees[kind], kind=kind)
    for f in ds.files:
        assert tnl.npy_shape(f) == jnl.npy_shape(f) == np.load(f).shape


@pytest.mark.parametrize("kind,max_t,batch_size", [
    ("video", 3, 8), ("video", 6, None), ("audio", 7, 8), ("audio", 4, None),
])
def test_collate_paths_match_jax(trees, kind, max_t, batch_size):
    """Truncated at ``max_t``, zero-padded, rows past the paths empty."""
    ds = NpyFolderDataset(trees[kind], kind=kind)
    kw = dict(item_shape=np.load(ds.files[0]).shape[1:], max_t=max_t, batch_size=batch_size,
              normalize_u8=kind == "video", num_threads=3)
    got = tnl.native_collate_paths(ds.files, ds.all_labels, **kw)
    _assert_batches_equal([got], [jnl.native_collate_paths(ds.files, ds.all_labels, **kw)])
    lengths = [min(np.load(f).shape[0], max_t) for f in ds.files]
    assert got[2][: len(lengths)].tolist() == lengths


@pytest.mark.parametrize("kind", ["video", "audio"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_native_loader_matches_jax(trees, kind, shuffle):
    """Two epochs of ``make_native_loader`` (batch 4, buckets 3, 6 and 10,
    the last batch padded) bit-equal to JAX's; audio bit-equal to the Python
    ``DataLoader``, faces within one ulp of it."""
    ds = NpyFolderDataset(trees[kind], kind=kind)
    kw = dict(buckets=(3, 6, 10), shuffle=shuffle, seed=7, prefetch=0)
    got = tnl.make_native_loader(ds, 4, **kw)
    want = jnl.make_native_loader(ds, 4, **kw)
    py = DataLoader(ds, 4, buckets=(3, 6, 10), shuffle=shuffle, seed=7, prefetch=0)
    for _epoch in range(2):
        nat = list(got)
        _assert_batches_equal(nat, want)
        for n, p in zip(nat, py):
            np.testing.assert_array_equal(n[1], p[1])
            np.testing.assert_array_equal(n[2], p[2])
            if kind == "audio":
                np.testing.assert_array_equal(n[0], p[0])
            else:
                np.testing.assert_allclose(n[0], p[0], rtol=1.2e-7, atol=0)


def test_missing_file_raises_as_in_jax(trees):
    with pytest.raises(IOError):
        tnl.native_collate_paths(["/nonexistent.npy"], [0], item_shape=(13,), max_t=2)
    with pytest.raises(IOError):
        jnl.native_collate_paths(["/nonexistent.npy"], [0], item_shape=(13,), max_t=2)


def test_build_reads_native_and_writes_build(tmp_path, monkeypatch):
    """The library builds into the package's ``build/`` (keyed by a hash of
    the source and flags): ``native/``'s sources stay as they are and no
    build of the port's lands there; without g++ the loader raises
    ``ImportError`` naming why."""
    def sources():  # native/'s own files (the JAX wrappers build their .so there)
        return {f: (native_build.NATIVE_DIR / f).read_bytes()
                for f in os.listdir(native_build.NATIVE_DIR) if not f.endswith(".so")}

    before = sources()
    path = native_build.library_path("npy_collate")
    assert path.parent == native_build.BUILD_DIR and path.exists()
    assert tnl._load_lib()._name == str(path)
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native_build, "_errors", {})
    monkeypatch.setattr(native_build.shutil, "which", lambda name: None)
    native_build.load_library.cache_clear()
    try:
        with pytest.raises(ImportError, match="g\\+\\+ not found"):
            native_build.load_library("npy_collate")
        assert native_build.build("npy_collate") == {"npy_collate": "g++ not found"}
    finally:
        native_build.load_library.cache_clear()
    assert sources() == before
    assert not [f for f in os.listdir(native_build.NATIVE_DIR) if "-" in f]  # no port build
