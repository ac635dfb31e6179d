"""AU-patch and joint face + AU datasets and loaders (numpy only).

The port's copy of the JAX package's ``data/au_patches.py``:

* :func:`get_patch_image_loaders` -> ``(train, test, eval)`` loaders of
  ``(patches (B, T, A, h, w, 3), weights (B, T, A), labels, lengths)``;
* :func:`get_joint_dataloader` -> ``(train, test, eval)`` loaders of
  ``(videos, au_patches, labels, au_mask, au_weight, lengths)`` (without
  ``au_mask`` / ``au_weight`` unless ``return_weights``).

On disk, either flat split trees, ``{root}/{split}/{label}_{id}.npy`` patch
stacks ``(T, A, h, w, 3)`` with ``{label}_{id}_weights.npy`` ``(T, A)``
siblings (the joint loader pairs them with ``{video_root}/{split}`` face
stacks of the same stem), labels from the filename prefix; or, with a
FakeAVCeleb csv or a LAV-DF json, every ``.npy`` under the root, labelled and
split by the metadata (:func:`_match_stem`).

A seed gives the JAX loaders' batches: the same draws from the same
``np.random.Generator``, in the same order (the balance oversampling at
construction, then each item's augmentation, and the loader's shuffle or
weighted sampler). ``image_size`` resizes bilinearly on cv2's sampling grid
(:func:`_resize_frames`; the JAX loader calls cv2, whose float rounding
differs by a few ulps).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .collate import bucket_length
from .datasets import label_from_filename
from .loader import DataLoader
from .metadata import hash_split, load_fakeavceleb_csv, load_lavdf_json

SPLITS = ("train", "test", "eval")


def _list_stems(folder: str) -> List[str]:
    return sorted(f[:-4] for f in os.listdir(folder)
                  if f.endswith(".npy") and not f.endswith("_weights.npy"))


def _walk_stems(root: str) -> Dict[str, str]:
    """stem -> path of every patch ``.npy`` under ``root`` (flat or nested),
    ``_weights`` siblings excluded."""
    out: Dict[str, str] = {}
    for dirpath, _dirs, files in sorted(os.walk(root)):
        for f in sorted(files):
            if f.endswith(".npy") and not f.endswith("_weights.npy"):
                out[f[:-4]] = os.path.join(dirpath, f)
    return out


def _metadata_index(rows):
    """(full-path key, unique-basename key) lookups from ``(path, label,
    split)`` rows; a basename two rows disagree on is dropped."""
    full: Dict[str, Tuple[int, str]] = {}
    base: Dict[str, Tuple[int, str]] = {}
    dup = set()
    for path, label, split in rows:
        noext = os.path.splitext(path)[0]
        full[noext.replace("/", "_").replace("\\", "_")] = (label, split)
        bkey = os.path.basename(noext)
        if bkey in base and base[bkey] != (label, split):
            dup.add(bkey)
        base[bkey] = (label, split)
    for k in dup:
        base.pop(k)
    return full, base


def _match_stem(stem: str, full, base) -> Optional[Tuple[int, str]]:
    """The stem, or any suffix of it after an underscore (preprocessors
    prepend ``{label}_{subfolder}_``), against the full-path keys first,
    then the unique basenames."""
    cands = [stem] + [stem[i + 1:] for i, ch in enumerate(stem) if ch == "_"]
    for table in (full, base):
        for c in cands:
            if c in table:
                return table[c]
    return None


def _load_metadata_rows(mode: str, csv_path: Optional[str], lavdf_json: Optional[str]):
    if lavdf_json:
        return load_lavdf_json(lavdf_json)
    if csv_path:
        return load_fakeavceleb_csv(csv_path)
    raise ValueError(f"metadata mode {mode!r} requires csv_path or a LAV-DF json")


def _resolve_metadata_entries(root: str, rows, *, include_unmatched_real: bool = False,
                              unmatched_split_seed: int = 42) -> Dict[str, List[Tuple[str, int]]]:
    """split -> ``[(path, label), ...]`` for every patch ``.npy`` under
    ``root``, labelled and split by the metadata; unmatched stems dropped,
    or with ``include_unmatched_real`` labelled real and hash-split with the
    seed."""
    full, base = _metadata_index(rows)
    out: Dict[str, List[Tuple[str, int]]] = {s: [] for s in SPLITS}
    for stem, path in sorted(_walk_stems(root).items()):
        hit = _match_stem(stem, full, base)
        if hit is None:
            if not include_unmatched_real:
                continue
            hit = (0, hash_split(f"{unmatched_split_seed}:{stem}"))
        label, split = hit
        out.setdefault(split, []).append((path, label))
    return out


def _balance_oversample(entries: List[Tuple[str, int]], rng: np.random.Generator):
    """Append minority-class entries drawn with replacement until the classes
    are even."""
    labels = [lab for _, lab in entries]
    idx0 = [i for i, lab in enumerate(labels) if lab == 0]
    idx1 = [i for i, lab in enumerate(labels) if lab == 1]
    if not idx0 or not idx1:
        return entries
    minority, majority = (idx0, idx1) if len(idx0) < len(idx1) else (idx1, idx0)
    extra = rng.choice(minority, size=len(majority) - len(minority), replace=True)
    return [entries[i] for i in list(range(len(entries))) + [int(i) for i in extra]]


def _augment(arr: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """A horizontal flip and a brightness jitter, each with probability 1/2."""
    if rng.random() < 0.5:
        arr = arr[..., ::-1, :]
    if rng.random() < 0.5:
        arr = np.clip(arr * rng.uniform(0.85, 1.15), 0.0, 1.0)
    return np.ascontiguousarray(arr)


def _linear_taps(n_in: int, n_out: int):
    """cv2 ``INTER_LINEAR``'s taps along one axis: half-pixel centres, the
    source index clamped to the edge (its weight then 0)."""
    f = ((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s).astype(np.float32)
    f[s < 0], s[s < 0] = 0, 0
    edge = s >= n_in - 1
    f[edge], s[edge] = 0, n_in - 1
    return s, np.minimum(s + 1, n_in - 1), (1 - f).astype(np.float32), f


def _resize_frames(arr: np.ndarray, size: int) -> np.ndarray:
    """Bilinear-resize the trailing ``(h, w, 3)`` planes of float32 ``arr``
    to ``size``², rows then columns in float32 on cv2 ``INTER_LINEAR``'s grid
    (no antialiasing)."""
    if arr.shape[-3:-1] == (size, size):
        return arr
    y0, y1, wy0, wy1 = _linear_taps(arr.shape[-3], size)
    x0, x1, wx0, wx1 = _linear_taps(arr.shape[-2], size)
    rows = arr[..., x0, :] * wx0[:, None] + arr[..., x1, :] * wx1[:, None]
    out = rows[..., y0, :, :] * wy0[:, None, None] + rows[..., y1, :, :] * wy1[:, None, None]
    return np.ascontiguousarray(out, dtype=np.float32)


class AUPatchDataset:
    """Patch stacks, per-patch AU weights and a label. ``entries`` (explicit
    ``[(path, label), ...]``, e.g. resolved from metadata) replace the flat
    folder's filename labels."""

    def __init__(self, folder: Optional[str] = None, *,
                 entries: Optional[List[Tuple[str, int]]] = None,
                 image_size: Optional[int] = None, max_frames: Optional[int] = None,
                 max_aus: int = 17, augment: bool = False, seed: int = 0):
        self.image_size = image_size or None
        self.max_frames = max_frames
        self.max_aus = max_aus
        self.augment = augment
        self._rng = np.random.default_rng(seed)
        if entries is None:
            if folder is None:
                raise ValueError("AUPatchDataset needs a folder or explicit entries")
            entries = [(os.path.join(folder, s + ".npy"), label_from_filename(s + ".npy"))
                       for s in _list_stems(folder)]
        if augment:
            entries = _balance_oversample(entries, self._rng)
        self.entries = entries
        self.all_labels = [lab for _, lab in entries]

    @property
    def stems(self) -> List[str]:
        return [os.path.basename(p)[:-4] for p, _ in self.entries]

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, idx: int):
        path, label = self.entries[idx]
        patches = np.load(path).astype(np.float32)
        if patches.max() > 1.5:
            patches = patches / 255.0
        wpath = path[:-4] + "_weights.npy"
        weights = (np.load(wpath).astype(np.float32) if os.path.exists(wpath)
                   else np.ones(patches.shape[:2], np.float32))
        if self.max_frames is not None:
            patches, weights = patches[: self.max_frames], weights[: self.max_frames]
        patches, weights = patches[:, : self.max_aus], weights[:, : self.max_aus]
        if self.image_size:
            patches = _resize_frames(patches, self.image_size)
        if self.augment:
            patches = _augment(patches, self._rng)
        return patches, weights, label


def au_patch_collate(items, *, buckets=None, max_aus: int, batch_size: Optional[int] = None):
    """-> ``(patches (B, T, A, h, w, 3), weights (B, T, A), labels, lengths)``,
    zero-padded in T to a bucket, in A to ``max_aus`` and in B to
    ``batch_size`` (rows of length 0)."""
    T = bucket_length(max(p.shape[0] for p, _, _ in items), buckets)
    B = batch_size if batch_size is not None else len(items)
    patches = np.zeros((B, T, max_aus) + items[0][0].shape[2:], np.float32)
    weights = np.zeros((B, T, max_aus), np.float32)
    labels = np.zeros((B,), np.float32)
    lengths = np.zeros((B,), np.int32)
    for i, (p, wt, y) in enumerate(items):
        t, a = min(p.shape[0], T), p.shape[1]
        patches[i, :t, :a] = p[:t]
        weights[i, :t, :a] = wt[:t]
        labels[i] = y
        lengths[i] = t
    return patches, weights, labels, lengths


def get_patch_image_loaders(
    data_root: str,
    *,
    mode: str = "fakeavceleb",
    csv_path: Optional[str] = None,
    lavdf_json: Optional[str] = None,
    batch_size: int = 2,
    image_size: int = 128,
    max_frames: int = 60,
    max_aus: int = 17,
    num_workers: int = 0,
    buckets: Optional[Sequence[int]] = None,
    augment_train: bool = True,
    augment_eval: bool = False,
    augment_test: bool = False,
    include_unmatched_real: bool = False,
    unmatched_split_seed: int = 42,
    seed: int = 0,
) -> Tuple[DataLoader, DataLoader, DataLoader]:
    """``(train, test, eval)`` patch loaders; ``augment_*`` balances and
    augments a split, train shuffles. ``num_workers`` is the prefetch depth
    (at least 2) and the threads that load a batch's items."""
    if mode not in ("fakeavceleb", "lavdf"):
        raise ValueError(f"unknown mode {mode!r}")
    if mode == "lavdf" and not lavdf_json:
        raise ValueError("mode='lavdf' requires lavdf_json")
    buckets = tuple(buckets) if buckets else (max_frames,)
    if csv_path or lavdf_json:
        by_split = _resolve_metadata_entries(
            data_root, _load_metadata_rows(mode, csv_path, lavdf_json),
            include_unmatched_real=include_unmatched_real,
            unmatched_split_seed=unmatched_split_seed)
        entries = {s: by_split.get(s, []) for s in SPLITS}
    else:
        if include_unmatched_real:
            raise ValueError("include_unmatched_real requires a metadata source (csv_path)")
        entries = {s: None for s in SPLITS}

    def make(split, augment, shuffle):
        ds = AUPatchDataset(os.path.join(data_root, split) if entries[split] is None else None,
                            entries=entries[split], image_size=image_size,
                            max_frames=max_frames, max_aus=max_aus, augment=augment, seed=seed)
        return DataLoader(ds, batch_size, shuffle=shuffle, seed=seed,
                          prefetch=max(2, num_workers), item_workers=num_workers,
                          collate=lambda items: au_patch_collate(
                              items, buckets=buckets, max_aus=max_aus, batch_size=batch_size))

    return (make("train", augment_train, True), make("test", augment_test, False),
            make("eval", augment_eval, False))


class JointAUVideoDataset:
    """Face-frame stacks paired with AU patch stacks by filename stem."""

    def __init__(self, video_root: Optional[str], au_root: Optional[str], *,
                 entries: Optional[List[Tuple[str, str, int]]] = None,
                 image_size: Optional[int] = None, max_frames: Optional[int] = None,
                 max_aus: int = 17, seed: int = 0):
        """``entries``: explicit ``[(video_path, au_path, label), ...]``."""
        if entries is None:
            videos = {s: os.path.join(video_root, s + ".npy") for s in _list_stems(video_root)}
            entries = [(videos[s], os.path.join(au_root, s + ".npy"),
                        label_from_filename(s + ".npy"))
                       for s in _list_stems(au_root) if s in videos]
        self.entries = entries
        self.au = AUPatchDataset(entries=[(a, lab) for _, a, lab in entries],
                                 image_size=image_size, max_frames=max_frames,
                                 max_aus=max_aus, seed=seed)
        self.all_labels = self.au.all_labels
        self.image_size = image_size or None
        self.max_frames = max_frames

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, idx: int):
        patches, weights, label = self.au[idx]
        video = np.load(self.entries[idx][0]).astype(np.float32)
        if video.max() > 1.5:
            video = video / 255.0
        if self.max_frames is not None:
            video = video[: self.max_frames]
        if self.image_size:
            video = _resize_frames(video, self.image_size)
        return video, patches, weights, label


def joint_collate(items, *, buckets=None, max_aus: int, batch_size: Optional[int] = None):
    """-> ``(videos, au_patches, labels, au_mask, au_weight, lengths)``: both
    streams zero-padded to one bucketed T, ``au_mask`` 1 on real patches,
    ``lengths`` the longer stream's."""
    T = bucket_length(max(max(v.shape[0], p.shape[0]) for v, p, _, _ in items), buckets)
    B = batch_size if batch_size is not None else len(items)
    videos = np.zeros((B, T) + items[0][0].shape[1:], np.float32)
    patches = np.zeros((B, T, max_aus) + items[0][1].shape[2:], np.float32)
    au_mask = np.zeros((B, T, max_aus), np.float32)
    au_weight = np.zeros((B, T, max_aus), np.float32)
    labels = np.zeros((B,), np.float32)
    lengths = np.zeros((B,), np.int32)
    for i, (v, p, wt, y) in enumerate(items):
        tv, tp, a = min(v.shape[0], T), min(p.shape[0], T), p.shape[1]
        videos[i, :tv] = v[:tv]
        patches[i, :tp, :a] = p[:tp]
        au_mask[i, :tp, :a] = 1.0
        au_weight[i, :tp, :a] = wt[:tp]
        labels[i] = y
        lengths[i] = max(tv, tp)
    return videos, patches, labels, au_mask, au_weight, lengths


def _resolve_joint_metadata_entries(video_root: str, au_root: str, rows
                                    ) -> Dict[str, List[Tuple[str, str, int]]]:
    """split -> ``[(video_path, au_path, label), ...]``: stems under both
    roots, labelled and split by the metadata."""
    full, base = _metadata_index(rows)
    videos = _walk_stems(video_root)
    out: Dict[str, List[Tuple[str, str, int]]] = {s: [] for s in SPLITS}
    for stem, au_path in sorted(_walk_stems(au_root).items()):
        hit = _match_stem(stem, full, base) if stem in videos else None
        if hit is not None:
            label, split = hit
            out.setdefault(split, []).append((videos[stem], au_path, label))
    return out


def get_joint_dataloader(
    video_root: str,
    au_root: str,
    *,
    batch_size: int = 2,
    shuffle: bool = True,
    max_frames: int = 75,
    max_aus: int = 17,
    image_size: int = 128,
    num_workers: int = 0,
    csv_path: Optional[str] = None,
    lavdf_mode: bool = False,
    lavdf_json_path: Optional[str] = None,
    buckets: Optional[Sequence[int]] = None,
    return_weights: bool = True,
    seed: int = 0,
) -> Tuple[DataLoader, DataLoader, DataLoader]:
    """``(train, test, eval)`` joint loaders; ``csv_path`` or ``lavdf_mode``
    with ``lavdf_json_path`` take labels and splits from the metadata;
    ``image_size`` resizes both streams."""
    if lavdf_mode and not lavdf_json_path:
        raise ValueError("lavdf_mode=True requires lavdf_json_path")
    buckets = tuple(buckets) if buckets else (max_frames,)
    if csv_path or lavdf_mode:
        rows = load_lavdf_json(lavdf_json_path) if lavdf_mode else load_fakeavceleb_csv(csv_path)
        by_split = _resolve_joint_metadata_entries(video_root, au_root, rows)
        entries = {s: by_split.get(s, []) for s in SPLITS}
    else:
        entries = {s: None for s in SPLITS}

    def collate(items):
        out = joint_collate(items, buckets=buckets, max_aus=max_aus, batch_size=batch_size)
        if return_weights:
            return out
        videos, patches, labels, _mask, _weight, lengths = out
        return videos, patches, labels, lengths

    def make(split, do_shuffle):
        flat = entries[split] is None
        ds = JointAUVideoDataset(os.path.join(video_root, split) if flat else None,
                                 os.path.join(au_root, split) if flat else None,
                                 entries=entries[split], image_size=image_size,
                                 max_frames=max_frames, max_aus=max_aus, seed=seed)
        return DataLoader(ds, batch_size, shuffle=do_shuffle, seed=seed,
                          prefetch=max(2, num_workers), item_workers=num_workers,
                          collate=collate)

    return make("train", shuffle), make("test", False), make("eval", False)
