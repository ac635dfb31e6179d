"""Synthetic face-npy trees for smoke and end-to-end runs (numpy only).

The port's copy of the JAX package's ``data/synthetic.make_face_npy_tree``:
uint8 ``(T, H, W, 3)`` clips named ``{real|fake}_<i>.npy`` under
``train/``, ``eval/`` and ``test/``, fakes brighter by a weak class signal,
the same files as the JAX generator writes for a seed.
"""
from __future__ import annotations

import os

import numpy as np


def _signal(rng, label: int, strength: float = 0.35):
    return strength * label + rng.normal(0, 0.05)


def make_face_npy_tree(root: str, *, n_per_class: int = 4, frames: int = 6, size: int = 64,
                       seed: int = 0) -> str:
    """Write ``{root}/{split}/`` face npys for the train/eval/test splits."""
    rng = np.random.default_rng(seed)
    for split in ("train", "eval", "test"):
        d = os.path.join(root, split)
        os.makedirs(d, exist_ok=True)
        for label_name, label in (("real", 0), ("fake", 1)):
            for i in range(n_per_class):
                base = rng.uniform(0.3, 0.5) + _signal(rng, label)
                vid = np.clip(rng.normal(base, 0.1, (frames, size, size, 3)), 0, 1)
                np.save(os.path.join(d, f"{label_name}_{i}.npy"), (vid * 255).astype(np.uint8))
    return root
