"""ROC metrics (numpy only)."""
from .roc import (
    auc_trapezoid,
    average_precision_score,
    compute_acc_ap_and_counts,
    compute_eer_auc,
    compute_metrics_interp,
    pick_threshold,
    roc_auc_score,
    roc_curve,
)
