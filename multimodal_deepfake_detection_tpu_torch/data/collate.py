"""Padded batching with static-shape buckets (numpy only).

Counterpart of the JAX package's ``data/collate.py``: clips are padded up to
a bucket boundary so the engine and the train step see a small fixed set of
shapes, and a ``lengths`` vector rides along so padding can be masked.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def bucket_length(t: int, buckets: Optional[Sequence[int]]) -> int:
    """Smallest bucket >= t; ``t`` if there are no buckets; the largest bucket
    if ``t`` exceeds them all (the caller truncates)."""
    if not buckets:
        return t
    for b in buckets:
        if t <= b:
            return b
    return buckets[-1]


def pad_collate(
    items: Sequence[Tuple[np.ndarray, int]],
    *,
    buckets: Optional[Sequence[int]] = None,
    batch_size: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Zero-pad ``(seq_array, label)`` items to a common bucketed length:
    ``(batch (B, T, ...) float32, labels (B,) float32, lengths (B,) int32)``.

    Sequences longer than the largest bucket are truncated to it. With
    ``batch_size``, a short final batch is padded up to it with
    ``lengths == 0`` rows (losses mask them, the loop drops them)."""
    max_t = max(x.shape[0] for x, _ in items)
    T = bucket_length(max_t, buckets)
    B = batch_size if batch_size is not None else len(items)
    tail = items[0][0].shape[1:]
    batch = np.zeros((B, T) + tuple(tail), np.float32)
    lengths = np.zeros((B,), np.int32)
    labels = np.zeros((B,), np.float32)
    for i, (x, y) in enumerate(items):
        t = min(x.shape[0], T)
        batch[i, :t] = x[:t]
        lengths[i] = t
        labels[i] = y
    return batch, labels, lengths
