"""ROC metrics (numpy only)."""
from .roc import (
    auc_trapezoid,
    average_precision_score,
    compute_eer_auc,
    compute_metrics_interp,
    roc_auc_score,
    roc_curve,
)
