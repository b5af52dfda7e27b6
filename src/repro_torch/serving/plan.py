"""Leaf-compaction planning for federated forest prediction.

A fitted tree's heap arrays are mostly dead slots: a depth-``d`` heap has
``2^(d+1)-1`` nodes but at most ``2^d`` leaves, and in practice far fewer are
live.  Per tree, the heap ids of its live leaves are packed into a dense
``LeafTable`` so the one-round membership mask, its party sum, and the vote
contraction all run over ``L`` live-leaf slots instead of the full heap.

``is_leaf`` is shared structure (every party stores it identically, paper
§3.1 "keeping the node structure"), so the table is computed once from any
party's view — compaction adds no per-party state and no communication.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.tree import PartyTree
from repro_torch.core.types import ForestParams


class LeafTable(NamedTuple):
    """Per-tree live-leaf index table (capacity L).

    leaf_idx: (T, L) int32 — heap node id of each live leaf in ascending
              (heap) order; -1 pads up to the shared capacity.
    n_live:   (T,)   int32 — live-leaf count per tree (<= L).
    """

    leaf_idx: torch.Tensor
    n_live: torch.Tensor

    @property
    def capacity(self) -> int:
        return int(self.leaf_idx.shape[-1])


def build_leaf_table(trees: PartyTree, params: ForestParams, *,
                     pad_multiple: int = 8) -> LeafTable:
    """Plan the compact leaf layout of a fitted forest (host-side, once).

    Accepts a PartyTree stack with leading (T, ...) or (M, T, ...) axes —
    ``is_leaf`` is shared, so the first party's view is authoritative.  The
    capacity L is the max live-leaf count over trees, rounded up to
    ``pad_multiple`` and clamped to ``params.max_leaves``.  The table lives
    on the device of ``trees``.
    """
    is_leaf = torch.as_tensor(trees.is_leaf).cpu().numpy()
    if is_leaf.ndim == 3:                       # (M, T, nn) -> shared view
        is_leaf = is_leaf[0]
    t, nn = is_leaf.shape
    counts = is_leaf.sum(axis=1).astype(np.int32)
    cap = max(1, int(counts.max()) if t else 1)
    cap = -(-cap // pad_multiple) * pad_multiple
    cap = min(cap, params.max_leaves, nn)
    cap = max(cap, int(counts.max()) if t else 1)  # clamp never loses leaves
    idx = np.full((t, cap), -1, np.int32)
    for i in range(t):
        ids = np.flatnonzero(is_leaf[i])
        idx[i, : len(ids)] = ids
    dev = torch.as_tensor(trees.is_leaf).device
    return LeafTable(torch.as_tensor(idx, device=dev),
                     torch.as_tensor(counts, device=dev))


def compaction_ratio(table: LeafTable, params: ForestParams) -> float:
    """Dense mask columns / compact mask columns — the sum/vote shrink."""
    return params.n_nodes / max(table.capacity, 1)
