"""Deterministic batch loader with weighted sampling and prefetch (numpy only).

Counterpart of the JAX package's ``data/loader.py``: the same index order
for a seed (``np.random.default_rng(seed)``, reshuffled each epoch), the
same padded batches, and a background thread that prepares the next batches
while the step runs.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional, Sequence

import numpy as np

from .collate import pad_collate


def make_weighted_sampler(labels: Sequence[int], rng: np.random.Generator,
                          num_samples: Optional[int] = None):
    """Class-balanced with-replacement index sampler, weights 0.5 / count(class)."""
    labels = np.asarray(labels)
    counts = np.bincount(labels, minlength=2)
    w = np.where(labels == 1, 0.5 / max(counts[1], 1), 0.5 / max(counts[0], 1)).astype(np.float64)
    w = w / w.sum()
    n = num_samples or len(labels)

    def sample() -> np.ndarray:
        return rng.choice(len(labels), size=n, replace=True, p=w)

    return sample


class DataLoader:
    """Iterates a dataset in padded batches.

    Args:
        dataset: indexable with ``__len__`` returning (array, label) items.
        batch_size: items per batch (the last partial batch is kept).
        shuffle: reshuffle the indices each epoch from the seed's generator.
        weighted: class-balanced with-replacement sampling per epoch.
        buckets: static pad-length buckets (see collate.pad_collate).
        collate: override the collate fn (signature of pad_collate).
        prefetch: number of batches prepared ahead on a background thread.
        pad_batch: pad a short last batch up to ``batch_size``.
        item_workers: when > 0, a batch's items load on a thread pool of that
            size (npy reads and resizes release the GIL), in order: the
            batches equal ``item_workers=0``'s unless items draw from a
            shared generator (augmentation), whose draws then race.
    """

    def __init__(
        self,
        dataset,
        batch_size: int = 1,
        *,
        shuffle: bool = False,
        weighted: bool = False,
        seed: int = 0,
        buckets: Optional[Sequence[int]] = None,
        collate: Optional[Callable] = None,
        drop_last: bool = False,
        prefetch: int = 2,
        pad_batch: bool = True,
        item_workers: int = 0,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.weighted = weighted
        self.buckets = buckets
        self.collate = collate or (
            lambda items: pad_collate(
                items, buckets=buckets, batch_size=batch_size if pad_batch else None
            )
        )
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.item_workers = int(item_workers)
        self._pool = None  # made at the first threaded batch, kept across epochs
        self.rows: Optional[Callable[[int], slice]] = None  # set by shard_rows()
        self._rng = np.random.default_rng(seed)
        self._epoch = 0

    def shard_rows(self, rows: Callable[[int], slice]) -> None:
        """Load and collate only the items at positions ``rows(batch_size)``
        of each (padded) batch: a data-parallel rank's block
        (``parallel/distributed.py::RankRows``). A batch whose block holds
        pad rows only is then None."""
        self.rows = rows

    def _load_items(self, chunk: np.ndarray) -> list:
        if self.item_workers <= 0 or len(chunk) <= 1:
            return [self.dataset[int(i)] for i in chunk]
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(max_workers=self.item_workers,
                                            thread_name_prefix="item-loader")
        return list(self._pool.map(lambda i: self.dataset[int(i)], chunk))

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _epoch_indices(self) -> np.ndarray:
        if self.weighted:
            return make_weighted_sampler(self.dataset.all_labels, self._rng)()
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(idx)
        return idx

    def _batches(self) -> Iterator:
        idx = self._epoch_indices()
        self._epoch += 1
        for start in range(0, len(idx), self.batch_size):
            chunk = idx[start : start + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                return
            if self.rows is not None:
                chunk = chunk[self.rows(self.batch_size)]
            yield self.collate(self._load_items(chunk)) if len(chunk) else None

    def __iter__(self) -> Iterator:
        if self.prefetch <= 0:
            yield from self._batches()
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()

        def worker():
            try:
                for b in self._batches():
                    q.put(b)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            b = q.get()
            if b is sentinel:
                break
            yield b
        t.join()
