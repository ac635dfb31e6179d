"""npy-tree datasets with the reference's filename-label contract (numpy only).

Counterpart of the JAX package's ``data/datasets.py``: a flat folder of
``.npy`` arrays whose filename prefix is the label, ``real_*`` -> 0 and
anything else -> 1. Items become model-ready float32: face crops ``(T, H, W,
3)`` uint8 / 255 (``video``, NHWC as on disk), MFCC clips ``(T, 13)`` ->
``(T, 3, 13)`` by channel tripling (``audio``).
"""
from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np


def label_from_filename(path: str) -> int:
    name = os.path.basename(path)
    return 0 if name.split("_")[0].lower() == "real" else 1


def _video_transform(arr: np.ndarray) -> np.ndarray:
    return np.asarray(arr, np.float32) / 255.0


def _audio_transform(arr: np.ndarray) -> np.ndarray:
    arr = np.asarray(arr, np.float32)  # (T, 13)
    return np.repeat(arr[:, None, :], 3, axis=1)  # (T, 3, 13)


_TRANSFORMS = {"video": _video_transform, "audio": _audio_transform, "raw": np.asarray}


class NpyFolderDataset:
    """Flat folder of .npy files; the filename prefix is the label."""

    def __init__(self, folder_path: str, kind: str = "video", max_frames: Optional[int] = None):
        if kind not in _TRANSFORMS:
            raise ValueError(f"kind must be one of {sorted(_TRANSFORMS)}")
        self.folder_path = folder_path
        self.kind = kind
        self.max_frames = max_frames
        self.files: List[str] = sorted(
            os.path.join(folder_path, f) for f in os.listdir(folder_path) if f.endswith(".npy")
        )
        self.all_labels: List[int] = [label_from_filename(f) for f in self.files]

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, int]:
        arr = np.load(self.files[idx])
        if self.max_frames is not None:
            arr = arr[: self.max_frames]
        return _TRANSFORMS[self.kind](arr), self.all_labels[idx]

    def class_counts(self) -> Tuple[int, int]:
        labels = np.asarray(self.all_labels)
        return int((labels == 0).sum()), int((labels == 1).sum())
