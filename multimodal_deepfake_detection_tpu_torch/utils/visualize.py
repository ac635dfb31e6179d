"""t-SNE embedding plots (the test_au_face / test_au_patch export format).

The port's copy of ``multimodal_deepfake_detection_tpu/utils/visualize.py``,
numpy and scikit-learn on the host: subsample to a cap, perplexity clamped
to (n-1)/3, PCA init, one scatter per stream with real/fake classes, saved
as PNG at dpi 220 with the Agg backend (headless). The same ``X`` and seed
give the same ``Z`` as the JAX package's copy.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def run_tsne_and_plot(
    X: np.ndarray,
    y: np.ndarray,
    title: str,
    save_path: str,
    *,
    seed: int = 42,
    max_samples: Optional[int] = 2000,
    perplexity: float = 30.0,
    n_iter: int = 1000,
    log=print,
) -> Optional[np.ndarray]:
    if X.shape[0] == 0:
        log(f"[t-SNE] No data for {title}; skipped.")
        return None
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from sklearn.manifold import TSNE

    X = np.asarray(X, np.float32)
    y = np.asarray(y).astype(int)
    if max_samples is not None and X.shape[0] > max_samples:
        rng = np.random.default_rng(seed)
        idx = rng.choice(X.shape[0], size=max_samples, replace=False)
        X, y = X[idx], y[idx]

    tsne = TSNE(
        n_components=2,
        perplexity=min(perplexity, max(5, (X.shape[0] - 1) // 3)),
        max_iter=n_iter,
        init="pca",
        learning_rate="auto",
        random_state=seed,
    )
    Z = tsne.fit_transform(X)

    plt.figure(figsize=(7, 6))
    for mask, label in (((y == 0), "real"), ((y == 1), "fake")):
        plt.scatter(Z[mask, 0], Z[mask, 1], s=12, alpha=0.6, label=label)
    plt.title(title)
    plt.legend()
    plt.tight_layout()
    plt.savefig(save_path, dpi=220)
    plt.close()
    log(f"[t-SNE] Saved -> {save_path}")
    return Z
