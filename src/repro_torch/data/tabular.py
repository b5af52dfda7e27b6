"""Tabular data: synthetic analogues of the paper's benchmark suite.

The same generators as the JAX package's ``repro.data.tabular`` (NumPy,
bit-identical from the same seed): blob+rotation classification (an
informative low-rank subspace mixed across every column, plus noise) and a
nonlinear regression, with the (n_samples, n_features) signatures of the
paper's Table 2.
"""
from __future__ import annotations

import numpy as np


def make_classification(n: int, f: int, n_classes: int = 2, *,
                        n_informative: int | None = None, class_sep: float = 1.2,
                        seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    ni = n_informative or max(2, f // 4)
    ni = min(ni, f)
    centers = rng.normal(scale=class_sep, size=(n_classes, ni))
    y = rng.integers(0, n_classes, size=n)
    xi = centers[y] + rng.normal(size=(n, ni))
    mix = rng.normal(size=(ni, f)) / np.sqrt(ni)  # spread info across columns
    x = xi @ mix + 0.5 * rng.normal(size=(n, f))
    return x.astype(np.float64), y.astype(np.int64)


def make_regression(n: int, f: int, *, n_informative: int | None = None,
                    noise: float = 0.5, nonlinear: bool = True, seed: int = 0
                    ) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    ni = n_informative or max(2, f // 4)
    ni = min(ni, f)
    x = rng.normal(size=(n, f))
    w = rng.normal(size=ni)
    y = x[:, :ni] @ w
    if nonlinear:
        y = y + np.sin(2.0 * x[:, 0]) * np.abs(w).sum() * 0.3 + 0.5 * x[:, 1] * x[:, 2 % f]
    y = y + noise * rng.normal(size=n)
    return x.astype(np.float64), y.astype(np.float64)


def train_test_split(x, y, test_frac: float = 0.25, seed: int = 0):
    rng = np.random.default_rng(seed)
    n = len(y)
    perm = rng.permutation(n)
    cut = int(n * (1 - test_frac))
    tr, te = perm[:cut], perm[cut:]
    return x[tr], y[tr], x[te], y[te]
