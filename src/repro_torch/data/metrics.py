"""Metrics and the paper's Z-test (NumPy; no scipy or sklearn)."""
from __future__ import annotations

import math

import numpy as np


def accuracy(y_true, y_pred) -> float:
    return float(np.mean(np.asarray(y_true) == np.asarray(y_pred)))


def f1_binary(y_true, y_pred) -> float:
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    tp = float(np.sum((y_pred == 1) & (y_true == 1)))
    fp = float(np.sum((y_pred == 1) & (y_true == 0)))
    fn = float(np.sum((y_pred == 0) & (y_true == 1)))
    denom = 2 * tp + fp + fn
    return 2 * tp / denom if denom else 0.0


def rmse(y_true, y_pred) -> float:
    d = np.asarray(y_true, dtype=np.float64) - np.asarray(y_pred, dtype=np.float64)
    return float(np.sqrt(np.mean(d * d)))


def _phi(z: float) -> float:
    return 0.5 * (1.0 + math.erf(z / math.sqrt(2.0)))


def ztest_two_sample(a, b) -> tuple[float, float]:
    """Two-sample Z-test (paper §5.2): H0: means equal. Returns (z, p)."""
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    se = math.sqrt(a.var(ddof=1) / len(a) + b.var(ddof=1) / len(b))
    if se == 0.0:
        return 0.0, 1.0
    z = (a.mean() - b.mean()) / se
    return float(z), float(2.0 * (1.0 - _phi(abs(z))))
