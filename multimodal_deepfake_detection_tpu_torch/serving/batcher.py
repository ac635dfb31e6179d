"""Dynamic micro-batching for online serving on the card.

Counterpart of ``multimodal_deepfake_detection_tpu/serving/batcher.py``,
pointing at the port's scorers (``models/serve.py``) or at exported
programs (``models/artifact.py::ArtifactScorer``). Single-clip requests
leave the GPU almost idle; the :class:`MicroBatcher` coalesces concurrent
requests into micro-batches and pads BOTH variable axes to fixed buckets:

* the time/sample axis: inside the engines (their bucket dispatch);
* the batch axis: HERE, the stacked batch is padded up to a small fixed set
  of batch buckets (powers of two up to ``max_batch`` by default), so the
  engine sees at most ``len(batch_buckets) x len(time_buckets)`` shapes
  however traffic looks (a static-batch artifact sees its one batch).

Requests whose non-batch shapes cannot share one call (e.g. two AU-face
clips with different frame counts: the detector takes a scalar valid T)
are grouped by an adapter-defined *shape key* and batched only with
same-key peers.

Exactness: the engines score with folded BN and (in the default quality
mode) per-sample length masking, so a clip's score does not depend on what
it was batched with; batch-pad rows repeat the last real row (always
finite: no NaN through the attention softmaxes) and are sliced off before
the futures resolve.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "MicroBatcher",
    "VisualAdapter",
    "AudioAdapter",
    "AUFaceAdapter",
    "AUPatchAdapter",
    "AVAdapter",
]


def _pad_axis0(a: np.ndarray, n: int) -> np.ndarray:
    """Pad the leading axis to ``n`` rows by repeating the last real row."""
    if a.shape[0] >= n:
        return a
    return np.concatenate([a, np.repeat(a[-1:], n - a.shape[0], axis=0)], axis=0)


def _pad_time(a: np.ndarray, T: int) -> np.ndarray:
    """Zero-pad axis 0 of a single item (its time/sample axis) to ``T``."""
    if a.shape[0] == T:
        return a
    pad = np.zeros((T - a.shape[0],) + a.shape[1:], a.dtype)
    return np.concatenate([a, pad], axis=0)


class EngineAdapter:
    """Per-engine glue between request payloads and a scorer's batch API.

    ``fields`` maps payload array names to (dtype, min_ndim) for validation
    and JSON coercion; names listed in ``optional`` may be absent.
    """

    name: str = ""
    fields: Mapping[str, Tuple[np.dtype, int]] = {}
    optional: Sequence[str] = ()

    def validate(self, payload: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
        out = {}
        for key, (dtype, ndim) in self.fields.items():
            if key not in payload:
                if key in self.optional:
                    continue
                raise ValueError(f"{self.name}: missing required field '{key}'")
            a = np.asarray(payload[key], dtype)
            if a.ndim != ndim:
                raise ValueError(f"{self.name}: '{key}' must have {ndim} dims, got {a.ndim}")
            out[key] = a
        unknown = set(payload) - set(self.fields)
        if unknown:
            raise ValueError(f"{self.name}: unknown fields {sorted(unknown)}")
        return out

    def shape_key(self, item: Mapping[str, np.ndarray]) -> tuple:
        """Items batch together only when their keys match."""
        raise NotImplementedError

    def run(self, items: List[Mapping[str, np.ndarray]], pad_to: int) -> np.ndarray:
        """Score ``len(items)`` clips as one batch padded to ``pad_to`` rows;
        return exactly ``len(items)`` scores."""
        raise NotImplementedError


class VisualAdapter(EngineAdapter):
    """``frames``: (T, H, W, 3) uint8. Mixed T coalesces (per-item lengths)."""

    name = "visual"
    fields = {"frames": (np.uint8, 4)}

    def __init__(self, scorer):
        self.scorer = scorer

    def shape_key(self, item):
        return item["frames"].shape[1:]  # (H, W, 3)

    def run(self, items, pad_to):
        B = len(items)
        Tmax = max(it["frames"].shape[0] for it in items)
        frames = np.stack([_pad_time(it["frames"], Tmax) for it in items])
        lengths = np.array([it["frames"].shape[0] for it in items], np.int32)
        frames = _pad_axis0(frames, pad_to)
        lengths = _pad_axis0(lengths, pad_to)
        return self.scorer.score(frames, lengths)[:B]


class AudioAdapter(EngineAdapter):
    """``waveform``: (samples,) float32. Mixed durations coalesce exactly via
    :meth:`AudioScorer.score`'s per-row ``sample_lengths`` centering."""

    name = "audio"
    fields = {"waveform": (np.float32, 1)}

    def __init__(self, scorer):
        self.scorer = scorer

    def shape_key(self, item):
        return ()

    def run(self, items, pad_to):
        B = len(items)
        Smax = max(it["waveform"].shape[0] for it in items)
        waves = np.stack([_pad_time(it["waveform"], Smax) for it in items])
        sl = np.array([it["waveform"].shape[0] for it in items], np.int64)
        waves = _pad_axis0(waves, pad_to)
        sl = _pad_axis0(sl, pad_to)
        return self.scorer.score(waves, sample_lengths=sl)[:B]


class AUFaceAdapter(EngineAdapter):
    """``video``: (T, H, W, 3) u8; ``patches``: (Ta, A, h, w, 3) u8; optional
    ``au_mask``/``au_weight``: (Ta, A) f32. The detector's valid-T is a batch
    scalar, so only identically-shaped clips share a micro-batch."""

    name = "au_face"
    fields = {
        "video": (np.uint8, 4),
        "patches": (np.uint8, 5),
        "au_mask": (np.float32, 2),
        "au_weight": (np.float32, 2),
    }
    optional = ("au_mask", "au_weight")

    def __init__(self, scorer):
        self.scorer = scorer

    def shape_key(self, item):
        return item["video"].shape + item["patches"].shape

    def run(self, items, pad_to):
        B = len(items)
        videos = np.stack([it["video"] for it in items])
        patches = np.stack([it["patches"] for it in items])
        Ta, A = patches.shape[1:3]
        ones = np.ones((Ta, A), np.float32)
        mask = np.stack([it.get("au_mask", ones) for it in items])
        weight = np.stack([it.get("au_weight", ones) for it in items])
        videos, patches, mask, weight = (
            _pad_axis0(a, pad_to) for a in (videos, patches, mask, weight)
        )
        return self.scorer.score(videos, patches, au_mask=mask, au_weight=weight)[:B]


class AUPatchAdapter(EngineAdapter):
    """``patches``: (T, A, h, w, 3) u8; optional ``weights``: (T, A) f32.
    Mixed T coalesces (per-item lengths gate the biLSTM)."""

    name = "au_patch"
    fields = {"patches": (np.uint8, 5), "weights": (np.float32, 2)}
    optional = ("weights",)

    def __init__(self, scorer):
        self.scorer = scorer

    def shape_key(self, item):
        return item["patches"].shape[1:]  # (A, h, w, 3)

    def run(self, items, pad_to):
        B = len(items)
        Tmax = max(it["patches"].shape[0] for it in items)
        patches = np.stack([_pad_time(it["patches"], Tmax) for it in items])
        A = patches.shape[2]
        weights = np.stack(
            [
                _pad_time(it.get("weights", np.ones((it["patches"].shape[0], A), np.float32)), Tmax)
                for it in items
            ]
        )
        lengths = np.array([it["patches"].shape[0] for it in items], np.int32)
        patches, weights, lengths = (_pad_axis0(a, pad_to) for a in (patches, weights, lengths))
        return self.scorer.score(patches, weights, lengths)[:B]


class AVAdapter(EngineAdapter):
    """Paired ``frames`` + ``waveform`` through an :class:`AVScorer`."""

    name = "av"
    fields = {"frames": (np.uint8, 4), "waveform": (np.float32, 1)}

    def __init__(self, av_scorer):
        self.scorer = av_scorer

    def shape_key(self, item):
        return item["frames"].shape[1:]

    def run(self, items, pad_to):
        B = len(items)
        Tmax = max(it["frames"].shape[0] for it in items)
        Smax = max(it["waveform"].shape[0] for it in items)
        frames = _pad_axis0(np.stack([_pad_time(it["frames"], Tmax) for it in items]), pad_to)
        lengths = _pad_axis0(
            np.array([it["frames"].shape[0] for it in items], np.int32), pad_to
        )
        waves = _pad_axis0(np.stack([_pad_time(it["waveform"], Smax) for it in items]), pad_to)
        sl = _pad_axis0(np.array([it["waveform"].shape[0] for it in items], np.int64), pad_to)
        return self.scorer.score(frames, waves, lengths=lengths, sample_lengths=sl)[:B]


@dataclass
class _Pending:
    item: Mapping[str, np.ndarray]
    future: Future
    t_enqueue: float = field(default_factory=time.monotonic)


def _default_batch_buckets(max_batch: int) -> Tuple[int, ...]:
    buckets = []
    b = 1
    while b < max_batch:
        buckets.append(b)
        b *= 2
    buckets.append(max_batch)
    return tuple(buckets)


class MicroBatcher:
    """Coalesce concurrent single-clip requests into bucket-shaped batches.

    A dispatcher thread drains per-shape-key queues: a group is flushed as
    soon as it holds ``max_batch`` items, or when its oldest item has waited
    ``max_wait_ms`` (latency bound under light traffic). The stacked batch is
    padded up to the smallest ``batch_bucket`` >= its size before hitting the
    engine, keeping the set of shapes the engine sees fixed.

    Deadline accounting is ENGINE-AWARE: an item's wait budget starts at
    ``max(its enqueue, the moment the engine last went idle)``. Time a
    request spends queued behind a busy engine was unavoidable (it could not
    have been served earlier), so it does not burn the coalescing window.
    Without this, closed-loop traffic degenerates into alternating
    full/partial batches: while the engine scores a full batch, stragglers
    age past the deadline and flush as a rump batch the instant the engine
    frees (the JAX package measured 11.6/16 occupancy and a 21% throughput
    loss at small clips on its TPU); with it the stragglers get a fresh
    window in which the just-resolved clients resubmit, and batches fill.
    """

    def __init__(
        self,
        adapter: EngineAdapter,
        *,
        max_batch: int = 8,
        max_wait_ms: float = 5.0,
        batch_buckets: Optional[Sequence[int]] = None,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.adapter = adapter
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1000.0
        self.batch_buckets = tuple(
            sorted(batch_buckets) if batch_buckets else _default_batch_buckets(max_batch)
        )
        if self.batch_buckets[-1] < self.max_batch:
            raise ValueError("largest batch_bucket must cover max_batch")
        self._pending: "OrderedDict[tuple, deque]" = OrderedDict()
        self._cond = threading.Condition()
        self._engine_idle_since = time.monotonic()
        self._running = False
        self._thread: Optional[threading.Thread] = None
        # stats (guarded by _cond's lock)
        self._n_requests = 0
        self._n_batches = 0
        self._n_scored = 0
        self._n_pad_rows = 0
        self._n_errors = 0
        self._latencies: deque = deque(maxlen=1000)

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "MicroBatcher":
        with self._cond:
            if self._running:
                return self
            self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True, name=f"batcher-{self.adapter.name}")
        self._thread.start()
        return self

    def stop(self) -> None:
        with self._cond:
            self._running = False
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        # fail anything still queued
        with self._cond:
            for q in self._pending.values():
                for p in q:
                    p.future.set_exception(RuntimeError("batcher stopped"))
            self._pending.clear()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- client API --------------------------------------------------------
    def submit(self, **payload) -> Future:
        """Enqueue one clip; resolves to its float score."""
        item = self.adapter.validate(payload)
        key = self.adapter.shape_key(item)
        fut: Future = Future()
        with self._cond:
            if not self._running:
                raise RuntimeError("batcher is not running (call start())")
            self._pending.setdefault(key, deque()).append(_Pending(item, fut))
            self._n_requests += 1
            self._cond.notify_all()
        return fut

    def score_sync(self, timeout: Optional[float] = 30.0, **payload) -> float:
        """Blocking convenience wrapper around :meth:`submit`."""
        return float(self.submit(**payload).result(timeout=timeout))

    def stats(self) -> dict:
        with self._cond:
            lat = sorted(self._latencies)
            depth = sum(len(q) for q in self._pending.values())
            occ = self._n_scored / self._n_batches if self._n_batches else 0.0
            return {
                "engine": self.adapter.name,
                "requests": self._n_requests,
                "batches": self._n_batches,
                "scored": self._n_scored,
                "errors": self._n_errors,
                "mean_batch_occupancy": round(occ, 3),
                "pad_rows": self._n_pad_rows,
                "queue_depth": depth,
                "latency_ms_p50": round(lat[len(lat) // 2] * 1e3, 3) if lat else None,
                "latency_ms_p90": round(lat[int(len(lat) * 0.9)] * 1e3, 3) if lat else None,
                "batch_buckets": list(self.batch_buckets),
                "max_wait_ms": self.max_wait_s * 1e3,
            }

    # -- dispatcher --------------------------------------------------------
    def _bucket(self, n: int) -> int:
        for b in self.batch_buckets:
            if b >= n:
                return b
        return self.batch_buckets[-1]

    def _effective_age(self, p: _Pending, now: float) -> float:
        """Age against the coalescing window: waiting behind a busy engine
        does not count (see the class docstring's deadline accounting)."""
        return now - max(p.t_enqueue, self._engine_idle_since)

    def _take_group(self) -> Optional[List[_Pending]]:
        """Under the lock: pop a flushable group, or return None (caller
        waits). A group flushes when full or when its head's effective wait
        exceeded max_wait."""
        now = time.monotonic()
        oldest_key, oldest_age = None, -1.0
        for key, q in self._pending.items():
            if not q:
                continue
            if len(q) >= self.max_batch:
                return self._pop(key, self.max_batch)
            age = self._effective_age(q[0], now)
            if age > oldest_age:
                oldest_key, oldest_age = key, age
        if oldest_key is not None and oldest_age >= self.max_wait_s:
            return self._pop(oldest_key, self.max_batch)
        return None

    def _pop(self, key: tuple, n: int) -> List[_Pending]:
        q = self._pending[key]
        group = [q.popleft() for _ in range(min(n, len(q)))]
        if not q:
            del self._pending[key]
        return group

    def _loop(self) -> None:
        while True:
            with self._cond:
                group = None
                while self._running and (group := self._take_group()) is None:
                    # wake at the head item's effective deadline (or on new
                    # arrivals)
                    timeout = 0.05
                    now = time.monotonic()
                    for q in self._pending.values():
                        if q:
                            remaining = self.max_wait_s - self._effective_age(q[0], now)
                            timeout = max(1e-4, min(timeout, remaining))
                    self._cond.wait(timeout)
                if not self._running and group is None:
                    return
            self._run_group(group)
            with self._cond:
                # a fresh coalescing window opens for anything that queued
                # while the engine was busy
                self._engine_idle_since = time.monotonic()

    def _run_group(self, group: List[_Pending]) -> None:
        B = len(group)
        pad_to = self._bucket(B)
        try:
            scores = self.adapter.run([p.item for p in group], pad_to)
            scores = np.asarray(scores, np.float64)
            if scores.shape != (B,):
                raise RuntimeError(f"adapter returned {scores.shape}, expected ({B},)")
        except Exception as e:  # noqa: BLE001 — fail the requests, keep serving
            with self._cond:
                self._n_errors += B
            for p in group:
                if not p.future.cancelled():
                    p.future.set_exception(e)
            return
        done = time.monotonic()
        with self._cond:
            self._n_batches += 1
            self._n_scored += B
            self._n_pad_rows += pad_to - B
            for p in group:
                self._latencies.append(done - p.t_enqueue)
        for p, s in zip(group, scores):
            if not p.future.cancelled():
                p.future.set_result(float(s))
