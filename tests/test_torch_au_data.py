"""The port's AU loaders, synthetic trees and operating-point metrics against
the JAX package's.

* ``get_patch_image_loaders`` and ``get_joint_dataloader`` on the same trees
  and seeds: every array of every batch bit-equal, over three train epochs
  (shuffled; the patch loader's train and eval splits balanced by
  oversampling and augmented), on flat trees, with a FakeAVCeleb csv (with
  ``include_unmatched_real``) and a LAV-DF json, with and without
  ``return_weights``, through ``train_au_face``'s class-weighted sampler,
  and with ``num_workers`` item threads. The trees hold images at
  ``image_size`` (no resize) and uneven classes, so the balance draws.
* ``_resize_frames``: the JAX loader resizes with cv2, whose float rounding
  the port's numpy bilinear on the same grid matches within a few fp32
  ulps at unit scale (atol 1e-6; 4.5e-7 read on patches of 16^2 to 12^2);
  the patch loader at another ``image_size`` within the same bar.
* ``make_audio_npy_tree``, ``make_joint_tree`` and ``make_au_patch_tree``:
  byte-equal files.
* ``pick_threshold`` (Youden and FPR modes) and
  ``compute_acc_ap_and_counts`` within 1e-12.
"""
import csv
import json
import os

import numpy as np
import pytest

from multimodal_deepfake_detection_tpu.data import au_patches as jap
from multimodal_deepfake_detection_tpu.data import synthetic as jsyn
from multimodal_deepfake_detection_tpu.data.loader import DataLoader as JDataLoader
from multimodal_deepfake_detection_tpu.metrics import roc as jroc
from multimodal_deepfake_detection_tpu_torch.data import au_patches as tap
from multimodal_deepfake_detection_tpu_torch.data import synthetic as tsyn
from multimodal_deepfake_detection_tpu_torch.data.loader import DataLoader
from multimodal_deepfake_detection_tpu_torch.metrics import roc as troc

SIZE = 16
RESIZE_ATOL = 1e-6


def _write_patch(path, frames, seed, n_aus=3):
    rng = np.random.default_rng(seed)
    np.save(path, (rng.random((frames, n_aus, SIZE, SIZE, 3)) * 255).astype(np.uint8))
    np.save(path[:-4] + "_weights.npy", rng.random((frames, n_aus)).astype(np.float32))


def _write_video(path, frames, seed):
    rng = np.random.default_rng(seed + 100)
    np.save(path, (rng.random((frames, SIZE, SIZE, 3)) * 255).astype(np.uint8))


def _flat_trees(root):
    """Patch and face trees ``{root}/{au,video}/{split}``: 3 real and 1 fake
    per split (uneven, so balancing draws), of 2-4 frames."""
    for k, split in enumerate(("train", "test", "eval")):
        for d in ("au", "video"):
            os.makedirs(os.path.join(root, d, split), exist_ok=True)
        for i, name in enumerate(["real_0", "real_1", "real_2", "fake_0"]):
            seed = 10 * k + i
            frames = 2 + (i + len(split)) % 3
            _write_patch(os.path.join(root, "au", split, name + ".npy"), frames, seed)
            _write_video(os.path.join(root, "video", split, name + ".npy"), frames, seed)
    return os.path.join(root, "au"), os.path.join(root, "video")


def _metadata_trees(root):
    """Nested trees of 9 stems named by the preprocessors' convention, a
    FakeAVCeleb csv naming 7 of them with splits, and a LAV-DF json naming
    8; two stems are in neither."""
    au, video = os.path.join(root, "mau"), os.path.join(root, "mvideo")
    rows, lav = [], []
    splits = ["train", "train", "train", "eval", "eval", "test", "train", "test", "eval"]
    for i, split in enumerate(splits):
        real = i % 3 != 1
        stem = f"{'real' if real else 'fake'}_id{i:05d}_clip{i:03d}"
        sub = os.path.join("sub" + str(i % 2))
        for d in (au, video):
            os.makedirs(os.path.join(d, sub), exist_ok=True)
        _write_patch(os.path.join(au, sub, stem + ".npy"), 2 + i % 3, i)
        _write_video(os.path.join(video, sub, stem + ".npy"), 2 + i % 3, i)
        if i < 7:
            typ = "RealVideo-RealAudio" if real else "FakeVideo-FakeAudio"
            rows.append({"type": typ, "path": f"{typ}/men/id{i:05d}",
                         "filename": f"clip{i:03d}.mp4", "split": split})
        if i < 8:
            lav.append({"file": f"dev/clip{i:03d}.mp4", "n_fakes": 0 if real else 1,
                        "split": split if split != "eval" else "dev"})
    csv_path = os.path.join(root, "meta_data.csv")
    with open(csv_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["type", "path", "filename", "split"])
        w.writeheader()
        w.writerows(rows)
    json_path = os.path.join(root, "metadata.json")
    with open(json_path, "w") as f:
        json.dump(lav, f)
    return au, video, csv_path, json_path


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("au_data"))
    au, video = _flat_trees(root)
    mau, mvideo, csv_path, json_path = _metadata_trees(root)
    return dict(au=au, video=video, mau=mau, mvideo=mvideo, csv=csv_path, json=json_path)


def _assert_same_batches(ours, theirs, epochs=1):
    assert len(ours) == len(theirs)
    assert ours.dataset.all_labels == theirs.dataset.all_labels
    for _ in range(epochs):
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y)


def _patch_kwargs(trees, mode):
    kw = dict(batch_size=2, image_size=SIZE, max_frames=4, max_aus=3, seed=7,
              augment_train=True, augment_eval=True)
    if mode == "flat":
        return trees["au"], kw
    if mode == "csv":
        return trees["mau"], dict(kw, csv_path=trees["csv"], include_unmatched_real=True,
                                  unmatched_split_seed=3)
    if mode == "lavdf":
        return trees["mau"], dict(kw, mode="lavdf", lavdf_json=trees["json"])
    return trees["au"], dict(kw, num_workers=2, augment_train=False, augment_eval=False)


@pytest.mark.parametrize("mode", ["flat", "csv", "lavdf", "item_workers"])
def test_patch_loaders_match_jax(trees, mode):
    root, kw = _patch_kwargs(trees, mode)
    ours = tap.get_patch_image_loaders(root, **kw)
    theirs = jap.get_patch_image_loaders(root, **kw)
    for o, t, epochs in zip(ours, theirs, (3, 1, 1)):  # train, test, eval
        if len(t.dataset):
            _assert_same_batches(o, t, epochs)
    if mode == "flat":  # the balance drew: train holds 3 + 3 entries
        assert ours[0].dataset.all_labels.count(1) == 3


def _joint_kwargs(trees, mode):
    kw = dict(batch_size=2, image_size=SIZE, max_frames=4, max_aus=3, seed=11)
    if mode in ("flat", "no_weights", "weighted"):
        kw = dict(kw, return_weights=mode != "no_weights")
        return trees["video"], trees["au"], kw
    if mode == "csv":
        return trees["mvideo"], trees["mau"], dict(kw, csv_path=trees["csv"])
    return trees["mvideo"], trees["mau"], dict(kw, lavdf_mode=True, lavdf_json_path=trees["json"])


@pytest.mark.parametrize("mode", ["flat", "no_weights", "weighted", "csv", "lavdf"])
def test_joint_loaders_match_jax(trees, mode):
    vroot, aroot, kw = _joint_kwargs(trees, mode)
    ours = tap.get_joint_dataloader(vroot, aroot, **kw)
    theirs = jap.get_joint_dataloader(vroot, aroot, **kw)
    if mode == "weighted":  # as train_au_face wraps the train split
        ours = (DataLoader(ours[0].dataset, 2, weighted=True, seed=11,
                           collate=ours[0].collate),)
        theirs = (JDataLoader(theirs[0].dataset, 2, weighted=True, seed=11,
                              collate=theirs[0].collate),)
    for o, t in zip(ours, theirs):
        if len(t.dataset):
            _assert_same_batches(o, t, 3)


@pytest.mark.parametrize("shape,size", [((3, 2, 16, 16, 3), 8), ((2, 40, 40, 3), 32),
                                        ((2, 24, 20, 3), 128)])
def test_resize_matches_cv2(shape, size):
    x = np.random.default_rng(size).random(shape, dtype=np.float32)
    got, want = tap._resize_frames(x, size), jap._resize_frames(x, size)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_ATOL)


def test_patch_loader_resizes_like_jax(trees):
    kw = dict(batch_size=2, image_size=12, max_frames=4, max_aus=3, seed=5,
              augment_train=False)
    ours = tap.get_patch_image_loaders(trees["au"], **kw)[0]
    theirs = jap.get_patch_image_loaders(trees["au"], **kw)[0]
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a[0], b[0], rtol=0, atol=RESIZE_ATOL)
        for x, y in zip(a[1:], b[1:]):
            assert np.array_equal(x, y)


@pytest.mark.parametrize("kind", ["audio", "joint", "au_patch"])
def test_synthetic_trees_match_jax(tmp_path, kind):
    if kind == "audio":
        tsyn.make_audio_npy_tree(str(tmp_path / "t"), n_per_class=2, frames=5, seed=3)
        jsyn.make_audio_npy_tree(str(tmp_path / "j"), n_per_class=2, frames=5, seed=3)
    elif kind == "joint":
        tsyn.make_joint_tree(str(tmp_path / "t" / "v"), str(tmp_path / "t" / "a"), n_per_class=1,
                             frames=2, n_aus=2, face_size=8, patch_size=4, seed=3)
        jsyn.make_joint_tree(str(tmp_path / "j" / "v"), str(tmp_path / "j" / "a"), n_per_class=1,
                             frames=2, n_aus=2, face_size=8, patch_size=4, seed=3)
    else:
        tsyn.make_au_patch_tree(str(tmp_path / "t"), n_per_class=2, frames=2, n_aus=2, size=4,
                                seed=3)
        jsyn.make_au_patch_tree(str(tmp_path / "j"), n_per_class=2, frames=2, n_aus=2, size=4,
                                seed=3)
    files = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "t")
                   for d, _, fs in os.walk(tmp_path / "t") for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), tmp_path / "j")
                           for d, _, fs in os.walk(tmp_path / "j") for f in fs)
    for rel in files:
        a, b = np.load(tmp_path / "t" / rel), np.load(tmp_path / "j" / rel)
        assert a.dtype == b.dtype and np.array_equal(a, b), rel


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_operating_points_match_jax(seed):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, 40)
    y[:2] = (0, 1)
    s = np.round(rng.random(40) + 0.3 * y, 2)  # ties
    for mode, target in (("youden", 0.01), ("fpr", 0.05), ("fpr", 0.2), ("fpr", 0.0)):
        got = troc.pick_threshold(y, s, mode=mode, fpr_target=target)
        want = jroc.pick_threshold(y, s, mode=mode, fpr_target=target)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
        for thr in (got[0], 0.5):
            a = troc.compute_acc_ap_and_counts(y, s, thr)
            b = jroc.compute_acc_ap_and_counts(y, s, thr)
            assert a[2:] == b[2:]
            np.testing.assert_allclose(a[:2], b[:2], rtol=1e-12, atol=1e-12)
    one = troc.compute_acc_ap_and_counts(np.zeros(3), [0.1, 0.2, 0.3], 0.15)
    assert np.isnan(one[1]) and one[2:] == jroc.compute_acc_ap_and_counts(
        np.zeros(3), [0.1, 0.2, 0.3], 0.15)[2:]
