"""ROC / AUC / pAUC / EER / AP metric suite, numpy only.

The port's own copy of ``multimodal_deepfake_detection_tpu/metrics/roc.py``
(the JAX package's is checked against scikit-learn): the training loop's
metrics, in the two conventions the reference's harnesses use:

* **variant A** (``compute_eer_auc``): step-wise pAUC@0.1 on raw ROC points and
  nearest-point EER — the reference's ``train_au_face.py:462-473`` and
  ``test_au_face.py``/``train_au_patch.py``.
* **variant B** (``compute_metrics_interp``): pAUC on an interpolated FPR grid
  normalized so 0 = random, and EER from the linear interpolation of the
  fpr/fnr crossing, plus ACC@Youden — the reference's ``test_visual.py:515-565``.

``TrainLoop(metrics_variant=...)`` picks one.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

_trapezoid = getattr(np, "trapezoid", None) or np.trapz  # numpy < 2 has only trapz


def _as_arrays(labels, scores):
    y = np.asarray(labels).astype(int).ravel()
    s = np.asarray(scores).astype(float).ravel()
    return y, s


def roc_curve(labels, scores, drop_intermediate: bool = False):
    """sklearn-compatible ROC curve: (fpr, tpr, thresholds), thresholds descending.

    Includes sklearn's prepended (0, 0) point with threshold = inf.
    """
    y, s = _as_arrays(labels, scores)
    order = np.argsort(-s, kind="stable")
    y, s = y[order], s[order]
    distinct = np.where(np.diff(s))[0]
    threshold_idxs = np.r_[distinct, y.size - 1]
    tps = np.cumsum(y)[threshold_idxs].astype(float)
    fps = (1 + threshold_idxs) - tps
    thresholds = s[threshold_idxs]
    if drop_intermediate and len(fps) > 2:
        optimal = np.where(
            np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True]
        )[0]
        fps, tps, thresholds = fps[optimal], tps[optimal], thresholds[optimal]
    tps = np.r_[0.0, tps]
    fps = np.r_[0.0, fps]
    thresholds = np.r_[np.inf, thresholds]
    P = max(tps[-1], 1e-300)
    N = max(fps[-1], 1e-300)
    return fps / N, tps / P, thresholds


def auc_trapezoid(x, y) -> float:
    """Trapezoidal area (sklearn.metrics.auc)."""
    x = np.asarray(x, float)
    y = np.asarray(y, float)
    if x.size < 2:
        return float("nan")
    direction = 1.0
    dx = np.diff(x)
    if np.all(dx <= 0):
        direction = -1.0
    return float(direction * _trapezoid(y, x))


def roc_auc_score(labels, scores) -> float:
    fpr, tpr, _ = roc_curve(labels, scores)
    return auc_trapezoid(fpr, tpr)


def average_precision_score(labels, scores) -> float:
    """Step-interpolated AP (sklearn definition: sum (R_i - R_{i-1}) * P_i)."""
    y, s = _as_arrays(labels, scores)
    order = np.argsort(-s, kind="stable")
    y = y[order]
    s_sorted = s[order]
    tps = np.cumsum(y).astype(float)
    fps = np.cumsum(1 - y).astype(float)
    # collapse ties: evaluate at the last index of each distinct score
    distinct = np.r_[np.where(np.diff(s_sorted))[0], y.size - 1]
    tps, fps = tps[distinct], fps[distinct]
    P = tps[-1]
    if P == 0:
        return float("nan")
    precision = tps / np.maximum(tps + fps, 1e-300)
    recall = tps / P
    recall_prev = np.r_[0.0, recall[:-1]]
    return float(np.sum((recall - recall_prev) * precision))


# ---------------------------------------------------------------------------
# Variant A — train_au_face.py:462-473 style
# ---------------------------------------------------------------------------

def compute_eer_auc(labels, scores) -> Tuple[float, float, float, Tuple[np.ndarray, np.ndarray]]:
    """(auc, pauc@0.1, eer, (fpr, tpr)) with raw-point pAUC and nearest-point EER."""
    y, s = _as_arrays(labels, scores)
    fpr, tpr, _ = roc_curve(y, s, drop_intermediate=False)
    fnr = 1 - tpr
    auc_score = auc_trapezoid(fpr, tpr) if len(fpr) else float("nan")
    mask = fpr <= 0.1
    pauc = auc_trapezoid(fpr[mask], tpr[mask]) / 0.1 if np.sum(mask) >= 2 else float("nan")
    idx = int(np.nanargmin(np.abs(fpr - fnr))) if len(fpr) else 0
    eer = float((fpr[idx] + fnr[idx]) / 2.0) if len(fpr) else float("nan")
    return auc_score, pauc, eer, (fpr, tpr)


# ---------------------------------------------------------------------------
# Variant B — test_visual.py:515-565 style
# ---------------------------------------------------------------------------

def compute_metrics_interp(labels, scores, alpha: float = 0.1) -> Dict[str, float]:
    """AUC/AP + interpolated-normalized pAUC + interpolated-crossing EER + ACC@J."""
    y, s = _as_arrays(labels, scores)
    if len(np.unique(y)) < 2:
        return {"AUC": 0.0, "pAUC": 0.0, "AP": 0.0, "EER": 1.0}

    auc_score = roc_auc_score(y, s)
    ap_score = average_precision_score(y, s)
    fpr, tpr, thresholds = roc_curve(y, s)

    grid = np.linspace(0.0, alpha, 2001)
    tpr_i = np.interp(grid, fpr, tpr)
    pauc_raw = auc_trapezoid(grid, tpr_i)
    pauc_norm = (pauc_raw - (alpha**2) / 2) / (alpha - (alpha**2) / 2)

    fnr = 1 - tpr
    diff = fpr - fnr
    idx = np.where(np.diff(np.sign(diff)) != 0)[0]
    if len(idx) == 0:
        j = int(np.argmin(np.abs(diff)))
        eer = (fpr[j] + fnr[j]) / 2.0
    else:
        j = idx[0]
        x1, y1 = fpr[j], fnr[j]
        x2, y2 = fpr[j + 1], fnr[j + 1]
        w = (y1 - x1) / ((x2 - x1) - (y2 - y1) + 1e-12)
        w = np.clip(w, 0.0, 1.0)
        eer = x1 + w * (x2 - x1)

    j_scores = tpr - fpr
    j_ix = int(np.argmax(j_scores))
    thr_j = thresholds[j_ix]
    acc_j = float(((s >= thr_j).astype(int) == y).mean())

    return {
        "AUC": float(auc_score),
        "AP": float(ap_score),
        "pAUC": float(pauc_norm),
        "EER": float(eer),
        "ACC@J": acc_j,
        "THR@J": float(thr_j),
    }


# ---------------------------------------------------------------------------
# Operating points
# ---------------------------------------------------------------------------

def pick_threshold(labels, scores, mode: str = "youden", fpr_target: float = 0.01):
    """-> ``(threshold, fpr, tpr)``: the Youden-J point (``mode="youden"``),
    or the highest threshold whose FPR is at most ``fpr_target`` (any other
    mode; the first ROC point if none is)."""
    y, s = _as_arrays(labels, scores)
    fpr, tpr, thr = roc_curve(y, s, drop_intermediate=False)
    if len(fpr) == 0:
        return 0.5, 0.0, 0.0
    if mode == "youden":
        idx = int(np.argmax(tpr - fpr))
    else:
        ok = np.where(fpr <= float(fpr_target))[0]
        idx = int(ok[-1]) if len(ok) else 0
    return float(thr[idx]), float(fpr[idx]), float(tpr[idx])


def compute_acc_ap_and_counts(labels, scores, thr):
    """-> ``(acc, ap, correct_real, total_real, correct_fake, total_fake)``
    with ``scores >= thr`` called fake; AP is NaN on a single class."""
    y, s = _as_arrays(labels, scores)
    preds = (s >= float(thr)).astype(int)
    ap = float(average_precision_score(y, s)) if y.min() != y.max() else float("nan")
    return (float((preds == y).mean()), ap, int(((preds == 0) & (y == 0)).sum()),
            int((y == 0).sum()), int(((preds == 1) & (y == 1)).sum()), int((y == 1).sum()))
