"""Prediction-against-target scatter plot, counterpart of
``hamgnn_tpu/utils/visualization.py``."""

from __future__ import annotations

from typing import Optional

import numpy as np


def scatter_plot(pred: np.ndarray, target: np.ndarray, path: str,
                 max_points: int = 200_000) -> Optional[float]:
    """Scatter of ``pred`` against ``target`` (a sample of ``max_points``
    entries, seed 0) with the diagonal and the MAE in the title, written to
    ``path``; returns the MAE of the plotted entries.  Without matplotlib
    the plot is skipped with a note and None is returned."""
    try:
        import matplotlib
    except ImportError:
        print(f"matplotlib is not installed: {path} not written")
        return None

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pred = np.asarray(pred).ravel()
    target = np.asarray(target).ravel()
    if pred.size > max_points:
        idx = np.random.default_rng(0).choice(pred.size, max_points, replace=False)
        pred, target = pred[idx], target[idx]
    fig, ax = plt.subplots(figsize=(4, 4))
    ax.scatter(target, pred, s=2, alpha=0.3, edgecolors="none")
    lo = min(target.min(), pred.min())
    hi = max(target.max(), pred.max())
    ax.plot([lo, hi], [lo, hi], "r--", lw=0.8)
    ax.set_xlabel("target (Hartree)")
    ax.set_ylabel("prediction (Hartree)")
    mae = float(np.abs(pred - target).mean())
    ax.set_title(f"MAE = {mae:.3e} Ha")
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)
    return mae
