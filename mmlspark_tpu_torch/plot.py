"""Plotting helpers: confusion matrix + ROC.

Reference: src/plot/src/main/python/plot.py:17-40+ (`confusionMatrix` and
ROC helpers over a scored DataFrame, matplotlib/sklearn). Here the numerics
come from `automl.metrics` (pure numpy) and matplotlib only renders;
both functions also return the computed arrays so headless callers can skip
rendering entirely (ax=False).

A copy of mmlspark_tpu/plot.py over the port's `automl.metrics`. Host only:
matplotlib is imported only to render, so `ax=False` works without it.
"""

from __future__ import annotations

import numpy as np

from .automl.metrics import auc as _auc, roc_curve as _roc_curve
from .core.schema import Table

__all__ = ["confusion_matrix", "plot_confusion_matrix", "plot_roc"]


def confusion_matrix(table: Table, label_col: str = "label",
                     prediction_col: str = "scored_labels") -> np.ndarray:
    """(K, K) counts with rows = true class, cols = predicted class."""
    y = np.asarray(table[label_col], np.float64)
    p = np.asarray(table[prediction_col], np.float64)
    classes = np.unique(np.concatenate([y, p]))
    k = len(classes)
    yi = np.searchsorted(classes, y)
    pi = np.searchsorted(classes, p)
    m = np.zeros((k, k), np.int64)
    np.add.at(m, (yi, pi), 1)
    return m


def _axes(ax):
    """ax=False -> no rendering; ax=None -> a fresh standalone Figure axes
    (no pyplot state, no global-backend mutation — callers own the figure
    via ax.figure)."""
    if ax is False:
        return None
    if ax is not None:
        return ax
    from matplotlib.backends.backend_agg import FigureCanvasAgg
    from matplotlib.figure import Figure

    fig = Figure()
    FigureCanvasAgg(fig)
    return fig.add_subplot()


def plot_confusion_matrix(table: Table, label_col: str = "label",
                          prediction_col: str = "scored_labels", ax=None):
    """Reference plot.confusionMatrix (plot.py:17-30). Returns (matrix, ax);
    pass ax=False to skip rendering."""
    m = confusion_matrix(table, label_col, prediction_col)
    ax = _axes(ax)
    if ax is not None:
        ax.imshow(m, cmap="Blues")
        for (i, j), v in np.ndenumerate(m):
            ax.text(j, i, str(v), ha="center", va="center")
        ax.set_xlabel("predicted")
        ax.set_ylabel("true")
        ax.set_title("confusion matrix")
    return m, ax


def plot_roc(table: Table, label_col: str = "label",
             scores_col: str = "scores", ax=None):
    """Reference plot ROC helper (plot.py:32-40+). Returns
    ((fpr, tpr, thresholds), auc_value, ax); pass ax=False to skip
    rendering."""
    y = np.asarray(table[label_col], np.float64)
    s = np.asarray(table[scores_col], np.float64)
    fpr, tpr, thr = _roc_curve(y, s)
    auc_value = _auc(y, s)
    ax = _axes(ax)
    if ax is not None:
        ax.plot(fpr, tpr, label=f"AUC = {auc_value:.3f}")
        ax.plot([0, 1], [0, 1], linestyle="--", linewidth=0.8)
        ax.set_xlabel("false positive rate")
        ax.set_ylabel("true positive rate")
        ax.legend()
        ax.set_title("ROC")
    return (fpr, tpr, thr), auc_value, ax
