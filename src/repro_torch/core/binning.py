"""Quantile binning of raw features (LightGBM-style).

The paper searches exact thresholds over raw feature values.  We instead
discretize each feature once into <=256 quantile bins (uint8), so that split
finding becomes a histogram over (node, feature, bin) — the one kernel of the
fit.  Host-side NumPy, bit-identical to the JAX package's binning.

Binning is a *per-feature* transformation, so it is identical whether computed
by one central party or independently by each vertical party on its own
columns — losslessness of FF vs. the centralized baseline is unaffected.
"""
from __future__ import annotations

import numpy as np


def interior_quantiles(n_bins: int) -> np.ndarray:
    """The n_bins - 1 interior quantile levels a bin grid is cut at."""
    return np.linspace(0.0, 1.0, n_bins + 1)[1:-1]


def quantile_boundaries(x: np.ndarray, n_bins: int) -> np.ndarray:
    """Per-feature upper-boundary grid, shape (F, n_bins - 1).

    Bin b of feature f holds values in (boundaries[f, b-1], boundaries[f, b]].
    Constant features get degenerate (all-equal) boundaries and always land in
    bin 0, which makes every candidate split on them gainless.
    """
    x = np.asarray(x, dtype=np.float64)
    if x.ndim != 2:
        raise ValueError("expected (n_samples, n_features)")
    qs = interior_quantiles(n_bins)
    return np.quantile(x, qs, axis=0).T.astype(np.float64)  # (F, n_bins-1)


def apply_bins(x: np.ndarray, boundaries: np.ndarray) -> np.ndarray:
    """Digitize raw values into uint8 bin ids with the given boundaries."""
    x = np.asarray(x, dtype=np.float64)
    out = np.empty(x.shape, dtype=np.uint8)
    for f in range(x.shape[1]):  # per-feature searchsorted (fit-time, NumPy)
        out[:, f] = np.searchsorted(boundaries[f], x[:, f], side="left")
    return out


def bin_dataset(x: np.ndarray, n_bins: int) -> tuple[np.ndarray, np.ndarray]:
    """Fit + apply quantile binning. Returns (binned uint8, boundaries)."""
    b = quantile_boundaries(x, n_bins)
    return apply_bins(x, b), b
