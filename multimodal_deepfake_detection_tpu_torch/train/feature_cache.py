"""Frozen-backbone feature caching for the head-only training phases.

Counterpart of ``multimodal_deepfake_detection_tpu/train/feature_cache.py``.
With the backbone frozen and its BN in eval mode, the per-clip 2048-d
features do not change across epochs, so one backbone pass per batch feeds
every later epoch. The reference freezes parameters only and keeps its BN in
train mode, so caching is exact only in the eval-BN mode
(``backbone_bn_eval``), which the train CLIs imply with it; the cache keeps
the first epoch's batch order, so the loader must not shuffle.
"""
from __future__ import annotations

from typing import Callable, Iterable, Optional

import numpy as np


class FeatureCachingLoader:
    """Wrap a batch loader, replacing each ``(x, labels, lengths)`` batch with
    ``(features, labels, lengths)``: the first epoch runs ``feat_fn`` (the
    frozen backbone's forward, returning a host array) once per batch, and
    later epochs replay from host memory. A shuffling loader is refused
    unless ``allow_shuffle`` (its epoch-0 order would be frozen).

    Memory: ``n_clips * T * 2048 * 4`` bytes of host RAM (float32); ``dtype``
    stores them narrower."""

    def __init__(
        self,
        loader: Iterable,
        feat_fn: Callable[[np.ndarray], np.ndarray],
        *,
        dtype: Optional[np.dtype] = None,
        allow_shuffle: bool = False,
    ):
        if not allow_shuffle and bool(getattr(loader, "shuffle", False)):
            raise ValueError(
                "FeatureCachingLoader would freeze a shuffling loader's epoch-0 "
                "order; construct the loader with shuffle=False (or pass "
                "allow_shuffle=True deliberately)"
            )
        self.loader = loader
        self.feat_fn = feat_fn
        self.dtype = dtype
        self._cache = None

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        if self._cache is None:
            cache = []
            for x, labels, lengths in self.loader:
                feats = np.asarray(self.feat_fn(x))
                if self.dtype is not None:
                    feats = feats.astype(self.dtype)
                cache.append((feats, np.asarray(labels), np.asarray(lengths)))
            self._cache = cache
        for feats, labels, lengths in self._cache:
            yield feats, labels, lengths

    def drop(self) -> None:
        """Release the cached features."""
        self._cache = None


class _EpochCounter:
    """Shared epoch position for a train/eval PhaseSwitchLoader pair."""

    def __init__(self):
        self.value = 0


class PhaseSwitchLoader:
    """Cached features while the backbone is frozen, raw batches after.

    Serves the first ``switch_epoch`` epochs from a feature cache and the
    raw loader from the unfreeze epoch on, freeing the cache. The step
    functions dispatch on the batch's rank (features are ``(B, T, F)``, raw
    frames ``(B, T, H, W, 3)``). A shared :class:`_EpochCounter` advances
    once per completed pass of the ``role='train'`` loader; the
    ``role='eval'`` loader reads it: after train epoch e it is e + 1, and the
    backbone is unchanged iff e + 1 <= switch_epoch."""

    def __init__(self, loader, feat_fn, *, switch_epoch: int, counter: _EpochCounter,
                 role: str = "train"):
        if bool(getattr(loader, "shuffle", False)):
            raise ValueError(
                "PhaseSwitchLoader would freeze a shuffling loader's epoch-0 order "
                "during the cached phase; construct the loader with shuffle=False"
            )
        if role not in ("train", "eval"):
            raise ValueError(role)
        self.loader = loader
        self.feat_fn = feat_fn
        self.switch_epoch = int(switch_epoch)
        self.counter = counter
        self.role = role
        self._cache = None

    def __len__(self):
        return len(self.loader)

    @property
    def dataset(self):
        return getattr(self.loader, "dataset", None)

    def _cached_batches(self):
        if self._cache is None:
            self._cache = [(np.asarray(self.feat_fn(x)), np.asarray(labels), np.asarray(lengths))
                           for x, labels, lengths in self.loader]
        return self._cache

    def __iter__(self):
        e = self.counter.value
        frozen = (e < self.switch_epoch) if self.role == "train" else (e <= self.switch_epoch)
        if frozen:
            yield from self._cached_batches()
        else:
            self._cache = None  # unfrozen: free the feature RAM
            yield from self.loader
        if self.role == "train":
            self.counter.value = e + 1
