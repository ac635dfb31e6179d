"""Host-side training loop shared by every train CLI.

Counterpart of ``multimodal_deepfake_detection_tpu/train/loop.py``:
per-epoch train and eval passes with accumulated scores, the metrics
(``basic`` or ``interp``), plateau LR stepping through
:func:`~.optim.set_learning_rate`, early stopping, and a best-checkpoint
policy:

* ``'loss'``: best eval loss;
* ``'loss_and_eer'``: joint best loss AND EER;
* ``'auc'``: best eval AUC.

The steps are whatever the CLI supplies. Step *i*'s loss and probabilities
are read on the host only after step *i + 1* is enqueued: the device's work
is asynchronous, so the host's collation, metric bookkeeping and next copy
overlap the device's step instead of waiting on it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..metrics import compute_eer_auc, compute_metrics_interp
from .optim import set_learning_rate
from .schedules import PlateauScheduler


@dataclasses.dataclass
class EpochResult:
    epoch: int
    train_loss: float
    train_metrics: Dict[str, float]
    eval_loss: Optional[float] = None
    eval_metrics: Optional[Dict[str, float]] = None
    eval_scores: Optional[tuple] = None  # (labels, probs) arrays from the eval pass
    lr: Optional[float] = None
    seconds: float = 0.0


def _host(x) -> np.ndarray:
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _metrics(variant: str, labels, probs) -> Dict[str, float]:
    labels = np.asarray(labels)
    probs = np.asarray(probs)
    if labels.size == 0 or len(np.unique(labels)) < 2:
        return {"AUC": 0.0, "pAUC": 0.0, "EER": 1.0, "AP": 0.0}
    if variant == "interp":
        return compute_metrics_interp(labels, probs)
    auc, pauc, eer, _ = compute_eer_auc(labels, probs)
    acc = float(((probs > 0.5).astype(int) == labels).mean())
    return {"AUC": auc, "pAUC": pauc, "EER": eer, "ACC": acc}


class _BestTracker:
    def __init__(self, policy: str):
        if policy not in ("loss", "loss_and_eer", "auc"):
            raise ValueError(f"unknown best policy {policy!r}")
        self.policy = policy
        self.best_loss = float("inf")
        self.best_eer = float("inf")
        self.best_auc = 0.0

    def update(self, loss: float, metrics: Dict[str, float]) -> bool:
        if self.policy == "loss":
            if loss < self.best_loss:
                self.best_loss = loss
                return True
            return False
        if self.policy == "loss_and_eer":
            eer = metrics.get("EER", float("inf"))
            if loss < self.best_loss and eer < self.best_eer:
                self.best_loss, self.best_eer = loss, eer
                return True
            return False
        auc = metrics.get("AUC", 0.0)
        if auc > self.best_auc:
            self.best_auc = auc
            return True
        return False


class TrainLoop:
    """Run epochs until done or early-stopped.

    Args:
        train_step: ``(state, batch, rng_seed_int, epoch) -> (state, loss, probs)``.
        eval_step: ``(state, batch) -> (loss, probs)``; probs feed the metrics.
        state: the :class:`~.state.TrainState` the steps update.
        num_epochs / eval_every / early_stop_patience: loop control.
        plateau: optional PlateauScheduler driven by the eval loss.
        best_policy: which best-checkpoint rule to apply.
        on_best: ``(state, epoch_result) -> None``, to persist the best bundle.
        on_epoch: ``(state, epoch_result) -> None`` after every epoch.
        metrics_variant: ``'basic'`` or ``'interp'``.
    """

    def __init__(
        self,
        *,
        train_step: Callable,
        eval_step: Callable,
        state: Any,
        train_loader,
        eval_loader,
        num_epochs: int,
        eval_every: int = 1,
        early_stop_patience: Optional[int] = None,
        plateau: Optional[PlateauScheduler] = None,
        best_policy: str = "loss",
        on_best: Optional[Callable] = None,
        on_epoch: Optional[Callable] = None,
        metrics_variant: str = "basic",
        log: Callable[[str], None] = print,
        seed: int = 0,
    ):
        self.train_step = train_step
        self.eval_step = eval_step
        self.state = state
        self.train_loader = train_loader
        self.eval_loader = eval_loader
        self.num_epochs = num_epochs
        self.eval_every = eval_every
        self.early_stop_patience = early_stop_patience
        self.plateau = plateau
        self.tracker = _BestTracker(best_policy)
        self.on_best = on_best
        self.on_epoch = on_epoch
        self.metrics_variant = metrics_variant
        self.log = log
        self.seed = seed
        self.history: List[EpochResult] = []

    @staticmethod
    def _collect(losses, all_probs, all_labels, pending):
        loss, probs, labels, lengths = pending
        losses.append(float(loss))
        # rows padded to fill a static batch carry lengths == 0: drop them
        mask = _host(lengths).ravel() > 0
        all_probs.extend(_host(probs).ravel()[mask].tolist())
        all_labels.extend(_host(labels).ravel().astype(int)[mask].tolist())

    def _pass(self, run, loader):
        losses, all_probs, all_labels = [], [], []
        pending = None
        for i, (batch, labels, lengths) in enumerate(loader):
            loss, probs = run(i, (batch, labels, lengths))
            if pending is not None:  # read step i - 1 now that step i is enqueued
                self._collect(losses, all_probs, all_labels, pending)
            pending = (loss, probs, labels, lengths)
        if pending is not None:
            self._collect(losses, all_probs, all_labels, pending)
        return float(np.mean(losses)) if losses else 0.0, all_labels, all_probs

    def _train_epoch(self, epoch: int):
        def run(i, batch):
            rng_seed = self.seed * 1_000_003 + epoch * 10_007 + i
            self.state, loss, probs = self.train_step(self.state, batch, rng_seed, epoch)
            return loss, probs

        return self._pass(run, self.train_loader)

    def _eval_epoch(self):
        return self._pass(lambda i, batch: self.eval_step(self.state, batch), self.eval_loader)

    def run(self) -> List[EpochResult]:
        early_stop_count = 0
        for epoch in range(self.num_epochs):
            t0 = time.time()
            train_loss, tl, tp = self._train_epoch(epoch)
            result = EpochResult(epoch, train_loss, _metrics(self.metrics_variant, tl, tp))

            if (epoch + 1) % self.eval_every == 0:
                eval_loss, el, ep = self._eval_epoch()
                result.eval_loss = eval_loss
                result.eval_metrics = _metrics(self.metrics_variant, el, ep)
                result.eval_scores = (np.asarray(el), np.asarray(ep))

                if self.plateau is not None:
                    new_lr = self.plateau.step(eval_loss)
                    result.lr = new_lr
                    set_learning_rate(self.state.optimizer, new_lr)

                if self.tracker.update(eval_loss, result.eval_metrics):
                    early_stop_count = 0
                    if self.on_best is not None:
                        self.on_best(self.state, result)
                else:
                    early_stop_count += 1

            result.seconds = time.time() - t0
            self.history.append(result)
            em = result.eval_metrics or {}
            self.log(
                f"epoch {epoch + 1}/{self.num_epochs} "
                f"train_loss={train_loss:.4f} "
                + (f"eval_loss={result.eval_loss:.4f} AUC={em.get('AUC', 0):.4f} "
                   f"EER={em.get('EER', 1):.4f} " if result.eval_loss is not None else "")
                + f"({result.seconds:.1f}s)"
            )
            if self.on_epoch is not None:
                self.on_epoch(self.state, result)
            if (
                self.early_stop_patience is not None
                and early_stop_count >= self.early_stop_patience
            ):
                self.log(f"early stopping at epoch {epoch + 1}")
                break
        return self.history
