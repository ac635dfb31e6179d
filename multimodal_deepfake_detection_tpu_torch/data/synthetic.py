"""Synthetic npy trees for smoke and end-to-end runs (numpy only).

The port's copy of the JAX package's ``data/synthetic.py``: files named
``{real|fake}_<i>.npy`` under ``train/``, ``eval/`` and ``test/``, fakes
shifted by a weak class signal, the same files as the JAX generators write
for a seed:

* face clips, uint8 ``(T, H, W, 3)``;
* MFCC clips, float32 ``(T, 13)``;
* AU patch stacks, uint8 ``(T, A, h, w, 3)``, with ``_weights.npy``
  siblings ``(T, A)`` float32; the joint tree pairs them with face clips of
  the same stem.
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


def make_audio_npy_tree(root: str, *, n_per_class: int = 4, frames: int = 20, n_mfcc: int = 13,
                        seed: int = 0) -> str:
    """Write ``{root}/{split}/`` MFCC npys for the train/eval/test splits."""
    rng = np.random.default_rng(seed)
    for split in ("train", "eval", "test"):
        d = os.path.join(root, split)
        os.makedirs(d, exist_ok=True)
        for label_name, label in (("real", 0), ("fake", 1)):
            for i in range(n_per_class):
                mfcc = rng.normal(_signal(rng, label, 1.5), 1.0, (frames, n_mfcc))
                np.save(os.path.join(d, f"{label_name}_{i}.npy"), mfcc.astype(np.float32))
    return root


def make_joint_tree(video_root: str, au_root: str, *, n_per_class: int = 3, frames: int = 4,
                    n_aus: int = 5, face_size: int = 64, patch_size: int = 32, seed: int = 0):
    """Face clips under ``video_root`` and AU patch stacks (with weights)
    under ``au_root``, of the same stems."""
    rng = np.random.default_rng(seed)
    for split in ("train", "eval", "test"):
        vd = os.path.join(video_root, split)
        ad = os.path.join(au_root, split)
        os.makedirs(vd, exist_ok=True)
        os.makedirs(ad, exist_ok=True)
        for label_name, label in (("real", 0), ("fake", 1)):
            for i in range(n_per_class):
                base = rng.uniform(0.3, 0.5) + _signal(rng, label)
                vid = np.clip(rng.normal(base, 0.1, (frames, face_size, face_size, 3)), 0, 1)
                patches = np.clip(rng.normal(base, 0.1, (frames, n_aus, patch_size, patch_size,
                                                         3)), 0, 1)
                w = rng.dirichlet(np.ones(n_aus), size=frames).astype(np.float32)
                np.save(os.path.join(vd, f"{label_name}_{i}.npy"), (vid * 255).astype(np.uint8))
                np.save(os.path.join(ad, f"{label_name}_{i}.npy"),
                        (patches * 255).astype(np.uint8))
                np.save(os.path.join(ad, f"{label_name}_{i}_weights.npy"), w)
    return video_root, au_root


def make_au_patch_tree(root: str, *, n_per_class: int = 3, frames: int = 4, n_aus: int = 5,
                       size: int = 32, seed: int = 0) -> str:
    """AU patch stacks ``{split}/{label}_{i}.npy`` with their weights."""
    rng = np.random.default_rng(seed)
    for split in ("train", "eval", "test"):
        d = os.path.join(root, split)
        os.makedirs(d, exist_ok=True)
        for label_name, label in (("real", 0), ("fake", 1)):
            for i in range(n_per_class):
                base = rng.uniform(0.3, 0.5) + _signal(rng, label)
                patches = np.clip(rng.normal(base, 0.1, (frames, n_aus, size, size, 3)), 0, 1)
                w = rng.dirichlet(np.ones(n_aus), size=frames).astype(np.float32)
                np.save(os.path.join(d, f"{label_name}_{i}.npy"), (patches * 255).astype(np.uint8))
                np.save(os.path.join(d, f"{label_name}_{i}_weights.npy"), w)
    return root
