"""Metadata-driven video datasets (numpy; cv2 and the native decoders lazily).

The port's copy of the JAX package's ``data/video_enhanced.py``, the
reference's ``video_dataloader_enhanced`` as its call sites use it:

    get_face_dataloader(folder_path, mode in {fakeavceleb, lavdf, lavdf_raw},
        subset in {train, dev/eval, test}, csv_path, lavdf_json, batch_size,
        augment_minority, shuffle, sample_percentage, raw_video,
        use_face_detection, frame_size, max_frames) -> loader
    loader.dataset.samples == [(path, label, subset), ...]
    batches are (video_batch, labels, seq_lengths)

Labels and splits come from ``data/metadata.py``: FakeAVCeleb's
``meta_data.csv`` (``fakeavceleb``; without a csv, a flat npy tree labelled
by filename) or LAV-DF's ``metadata.json`` (``lavdf``, ``lavdf_raw``).
``sample_percentage`` and ``augment_minority`` draw from
``np.random.default_rng(seed)`` in the JAX order, so the samples are the
same. ``lavdf_raw`` (or ``raw_video``) decodes each clip: the native
engines (``data/native_video.py``) unless face detection is on, else, and
for any file they do not handle, cv2 (optional face crop, resize, at most
``max_frames``), counted under ``cv2``. Otherwise items are ``.npy`` frame
stacks.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np

from .collate import pad_collate
from .datasets import label_from_filename
from .face_detect import crop_with_margin, make_detector
from .loader import DataLoader
from .metadata import _SPLIT_ALIASES, load_fakeavceleb_csv, load_lavdf_json


class EnhancedVideoDataset:
    """Samples resolved from metadata; items decoded from npy or raw video."""

    def __init__(
        self,
        folder_path: str,
        *,
        mode: str = "fakeavceleb",
        subset: str = "train",
        csv_path: Optional[str] = None,
        lavdf_json: Optional[str] = None,
        sample_percentage: float = 1.0,
        raw_video: Optional[bool] = None,
        use_face_detection: bool = False,
        face_detector: str = "center",
        frame_size: Tuple[int, int] = (224, 224),
        max_frames: int = 50,
        augment_minority: bool = False,
        native_decode: Optional[bool] = None,
        seed: int = 0,
    ):
        subset = _SPLIT_ALIASES.get(subset.lower(), subset)
        self.folder_path = folder_path
        self.mode = mode
        self.raw_video = bool(raw_video) if raw_video is not None else mode.endswith("_raw")
        self.use_face_detection = use_face_detection
        self._detector = make_detector(face_detector) if use_face_detection else None
        self.frame_size = tuple(frame_size)
        self.max_frames = max_frames
        # the native engines decode, resize and normalize in one pass; face
        # detection needs full frames, so it stays on cv2
        self.native_decode = (
            bool(native_decode) if native_decode is not None else not use_face_detection
        )
        rng = np.random.default_rng(seed)

        if mode in ("lavdf", "lavdf_raw"):
            if not lavdf_json:
                raise ValueError("lavdf modes require lavdf_json")
            rows = load_lavdf_json(lavdf_json)
        elif mode == "fakeavceleb":
            if csv_path:
                rows = load_fakeavceleb_csv(csv_path)
            else:  # a flat npy tree, labelled by filename prefix
                rows = [(f, label_from_filename(f), subset)
                        for f in sorted(os.listdir(folder_path)) if f.endswith(".npy")]
        else:
            raise ValueError(f"unknown mode {mode!r}")

        samples = [(p, l, s) for p, l, s in rows if s == subset]
        if sample_percentage < 1.0 and samples:
            keep = max(1, int(len(samples) * sample_percentage))
            idx = rng.choice(len(samples), size=keep, replace=False)
            samples = [samples[int(i)] for i in sorted(idx)]
        if augment_minority and samples:
            labels = [l for _, l, _ in samples]
            n0, n1 = labels.count(0), labels.count(1)
            if 0 < min(n0, n1) < max(n0, n1):
                minority = 0 if n0 < n1 else 1
                pool = [s for s in samples if s[1] == minority]
                extra = rng.choice(len(pool), size=max(n0, n1) - min(n0, n1), replace=True)
                samples = samples + [pool[int(i)] for i in extra]
        self.samples = samples
        self.all_labels = [l for _, l, _ in samples]

    def __len__(self):
        return len(self.samples)

    def _decode_video(self, path: str) -> np.ndarray:
        if self.native_decode and self._detector is None:
            from .native_video import decode_video

            arr = decode_video(path, size=self.frame_size, max_frames=self.max_frames)
            if arr is not None:
                return arr  # float32 RGB in [0, 1]
        import cv2

        from .native_video import count_engine

        cap = cv2.VideoCapture(path)
        frames = []
        try:
            while len(frames) < self.max_frames:
                ok, frame = cap.read()
                if not ok:
                    break
                frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
                if self._detector is not None:
                    box = self._detector(frame)
                    if box is None:
                        continue
                    frame = crop_with_margin(frame, box, margin=20)
                frames.append(cv2.resize(frame, self.frame_size))
        finally:
            cap.release()
        count_engine("cv2")
        if not frames:
            frames = [np.zeros(self.frame_size + (3,), np.uint8)]
        return np.stack(frames)

    def __getitem__(self, idx: int):
        rel, label, _ = self.samples[idx]
        path = rel if os.path.isabs(rel) else os.path.join(self.folder_path, rel)
        if self.raw_video:
            arr = self._decode_video(path)
        else:
            if not path.endswith(".npy"):
                path = path + ".npy"
            arr = np.load(path)[: self.max_frames]
        arr = arr.astype(np.float32)
        if arr.max() > 1.5:
            arr = arr / 255.0
        return arr, label


def get_face_dataloader(
    folder_path: str,
    *,
    mode: str = "fakeavceleb",
    subset: str = "train",
    csv_path: Optional[str] = None,
    lavdf_json: Optional[str] = None,
    batch_size: int = 1,
    augment_minority: bool = False,
    shuffle: bool = False,
    sample_percentage: float = 1.0,
    raw_video: Optional[bool] = None,
    use_face_detection: bool = False,
    frame_size: Tuple[int, int] = (224, 224),
    max_frames: int = 50,
    buckets: Optional[Sequence[int]] = None,
    seed: int = 0,
    num_workers: int = 0,
) -> DataLoader:
    """The loader of (video_batch, labels, seq_lengths); ``num_workers``
    decodes a batch's clips on that many threads (cv2 and the native engines
    release the GIL), the same batches in the same order."""
    ds = EnhancedVideoDataset(
        folder_path, mode=mode, subset=subset, csv_path=csv_path, lavdf_json=lavdf_json,
        sample_percentage=sample_percentage, raw_video=raw_video,
        use_face_detection=use_face_detection, frame_size=frame_size, max_frames=max_frames,
        augment_minority=augment_minority, seed=seed,
    )
    buckets = tuple(buckets) if buckets else (max_frames,)
    return DataLoader(
        ds, batch_size, shuffle=shuffle, seed=seed,
        collate=lambda items: pad_collate(items, buckets=buckets, batch_size=batch_size),
        item_workers=num_workers,
    )
