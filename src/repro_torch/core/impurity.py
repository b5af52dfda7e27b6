"""Impurity / gain computation from histogram statistics.

Gains are *absolute weighted impurity decreases* (parent - left - right of the
un-normalized impurity sums), matching CART's split ordering.  All quantities
are pure functions of histograms, so every party evaluates them identically —
a prerequisite for the exact-losslessness guarantee.
"""
from __future__ import annotations

import torch

_EPS = 1e-12


def stat_channels(y: torch.Tensor, task: str, n_classes: int) -> torch.Tensor:
    """Per-sample label statistics (N, C) accumulated by histograms."""
    if task == "classification":
        classes = torch.arange(n_classes, device=y.device)
        return (y[:, None] == classes[None, :]).to(torch.float32)
    y = y.to(torch.float32)
    return torch.stack([torch.ones_like(y), y, y * y], dim=-1)


def count_of(stats: torch.Tensor, task: str) -> torch.Tensor:
    """Weighted sample count from a stats vector (..., C)."""
    return stats.sum(-1) if task == "classification" else stats[..., 0]


def impurity_sum(stats: torch.Tensor, task: str) -> torch.Tensor:
    """Un-normalized impurity: n*gini (classification) or SSE (regression)."""
    if task == "classification":
        n = stats.sum(-1)                  # integer counts: exact in any order
        # squared counts above 2^12 round, and PyTorch's CPU and CUDA
        # reductions add them in different orders: add the classes one by
        # one, so every device gets the same bits
        sq = stats * stats
        sum_sq = sq[..., 0]
        for k in range(1, sq.shape[-1]):
            sum_sq = sum_sq + sq[..., k]
        return n - sum_sq / torch.clamp(n, min=_EPS)
    n, s1, s2 = stats[..., 0], stats[..., 1], stats[..., 2]
    return s2 - s1 * s1 / torch.clamp(n, min=_EPS)


def leaf_value(stats: torch.Tensor, task: str) -> torch.Tensor:
    """Leaf prediction from node stats: class distribution / mean target."""
    if task == "classification":
        n = torch.clamp(stats.sum(-1, keepdim=True), min=_EPS)
        return stats / n
    return stats[..., 1] / torch.clamp(stats[..., 0], min=_EPS)


def split_gains(hist: torch.Tensor, task: str, min_samples_leaf: int
                ) -> torch.Tensor:
    """Candidate gains for every (node, feature, split-bin).

    Args:
      hist: (L, F, B, C) histogram of label stats.
    Returns:
      (L, F, B-1) float32 gains; invalid splits are -inf.

    The prefix over bins is a cumulative sum along a dimension that is not
    the innermost (C follows it), which PyTorch scans sequentially for each
    (l, f, c) on the CPU and on the card; the total is the scan's last
    element.  So a feature's gains never depend on how many other features
    share the tensor — folding parties into one tensor is exact.  The scan
    runs in float64 and is rounded once per element: PyTorch's CPU scan of
    float32 accumulates in float64 but its CUDA scan in float32, so a
    float32 scan would give regression gains, and so splits, that differ
    between the card and the CPU.  This way both get the CPU's bits.
    """
    prefix = torch.cumsum(hist.double(), dim=2).float()  # (L, F, B, C)
    left = prefix[:, :, :-1]                             # (L, F, B-1, C)
    total = prefix[:, :, -1]                             # (L, F, C)
    right = total[:, :, None, :] - left
    parent = impurity_sum(total, task)[:, :, None]       # (L, F, 1)
    gain = parent - impurity_sum(left, task) - impurity_sum(right, task)
    nl, nr = count_of(left, task), count_of(right, task)
    ok = (nl >= min_samples_leaf) & (nr >= min_samples_leaf)
    return torch.where(ok, gain, float("-inf"))
