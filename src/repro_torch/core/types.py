"""Core typed configuration for the Federated Forest.

All static hyper-parameters live in one frozen, hashable params object that
tree building, prediction and the session share.  Field for field the same
as the JAX package's ``ForestParams``, including the "auto" resolution.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Task = Literal["classification", "regression"]


@dataclasses.dataclass(frozen=True)
class ForestParams:
    """Hyper-parameters of a (federated) random forest.

    Mirrors the knobs of the paper's CART + bagging setup (Alg. 1/2/5/6).
    """

    task: Task = "classification"
    n_classes: int = 2              # ignored for regression
    n_estimators: int = 10
    max_depth: int = 6
    min_samples_split: int = 2
    min_samples_leaf: int = 1
    min_impurity_decrease: float = 0.0
    n_bins: int = 32                # quantile bins (<= 256, stored as uint8)
    max_features: float = 1.0       # per-tree feature subsampling fraction (master-side)
    bootstrap: bool = True
    seed: int = 0
    # Beyond-paper (§Perf): sibling histogram = parent - left-child
    # (LightGBM's subtraction trick) — halves split-finding compute below the
    # root. Exact for classification (integer counts in f32); for regression
    # it reorders float sums, so it is a statistically-equivalent variant.
    hist_subtraction: bool = False
    # Frontier compaction (§Perf, tentpole): at depths where the heap level
    # is wider than ``frontier_cap``, live nodes are remapped into a dense
    # segment index of capacity min(2^d, n_samples, frontier_cap) and the
    # histogram/gain stage runs over compact slots, in as many passes as the
    # LIVE node count requires (a while_loop — compute scales with actual
    # sparsity, not worst-case width).  Results are scattered back to heap
    # order, so the built PartyTree is bit-identical to the dense build.
    # 0 disables compaction (the dense seed behavior); "auto" derives the
    # cap from (N, depth, n_bins) at fit time — see ``resolved``.
    frontier_cap: int | str = 256
    # Histogram backend: a key of kernels.ops.BACKENDS, or "auto" (the CUDA
    # kernel for tensors on the card, scatter for tensors on the CPU).
    hist_impl: str = "auto"
    # Bagging batching: how many trees build together.  Kept for parity with
    # the JAX package (here the trees are built one by one, so every
    # setting gives the same trees).  "auto" derives it at fit time.
    trees_per_batch: int | str = 1

    def __post_init__(self) -> None:
        if not (1 <= self.n_bins <= 256):
            raise ValueError("n_bins must be in [1, 256]")
        if self.max_depth < 1:
            raise ValueError("max_depth must be >= 1")
        if self.task not in ("classification", "regression"):
            raise ValueError(f"unknown task {self.task!r}")
        if not (0.0 < self.max_features <= 1.0):
            raise ValueError("max_features must be in (0, 1]")
        if isinstance(self.frontier_cap, str):
            if self.frontier_cap != "auto":
                raise ValueError(f"frontier_cap must be an int >= 0 or "
                                 f"'auto', got {self.frontier_cap!r}")
        elif self.frontier_cap < 0:
            raise ValueError("frontier_cap must be >= 0 (0 = dense build)")
        if isinstance(self.trees_per_batch, str):
            if self.trees_per_batch != "auto":
                raise ValueError(f"trees_per_batch must be an int >= 1 or "
                                 f"'auto', got {self.trees_per_batch!r}")
        elif self.trees_per_batch < 1:
            raise ValueError("trees_per_batch must be >= 1")

    # ---- "auto" build-knob resolution ----------------------------------------
    @property
    def needs_resolution(self) -> bool:
        """True while a build knob is still the "auto" placeholder — the
        params cannot parameterize a fit program until ``resolved``."""
        return (isinstance(self.frontier_cap, str)
                or isinstance(self.trees_per_batch, str))

    def resolved(self, n_samples: int) -> "ForestParams":
        """Replace "auto" build knobs with concrete values derived from the
        training-set size and the static shape knobs (N, depth, n_bins).

        Both knobs are perf-only: frontier compaction scatters results back
        to heap order and tree batching only regroups the bagging loop, so
        ANY resolution builds a forest bit-identical to any explicit
        setting (asserted in tests).  Explicit integer settings pass
        through untouched — the override escape hatch."""
        if not self.needs_resolution:
            return self
        changes: dict = {}
        if isinstance(self.frontier_cap, str):
            changes["frontier_cap"] = auto_frontier_cap(
                n_samples, self.max_depth, self.n_bins, self.n_stat_channels)
        if isinstance(self.trees_per_batch, str):
            changes["trees_per_batch"] = auto_trees_per_batch(
                n_samples, self.n_estimators, self.n_bins)
        return dataclasses.replace(self, **changes)

    # ---- derived static sizes -------------------------------------------------
    @property
    def n_nodes(self) -> int:
        """Total nodes of the complete binary tree (heap layout)."""
        return 2 ** (self.max_depth + 1) - 1

    @property
    def max_leaves(self) -> int:
        """Upper bound on live leaves of one tree.

        Leaves are disjoint, so a depth-``max_depth`` tree has at most
        ``2^max_depth`` of them — the static clamp for the serving layer's
        leaf-compacted prediction tables (serving/plan.py).
        """
        return 2 ** self.max_depth

    @property
    def n_stat_channels(self) -> int:
        """Label-statistic channels accumulated in histograms.

        classification: per-class (weighted) counts.
        regression:     (w, w*y, w*y^2) — enough for variance/SSE splits.
        """
        return self.n_classes if self.task == "classification" else 3

    def level_slice(self, depth: int) -> tuple[int, int]:
        """(offset, width) of the nodes at ``depth`` in heap layout."""
        return 2**depth - 1, 2**depth


def auto_frontier_cap(n_samples: int, max_depth: int, n_bins: int,
                      n_stat_channels: int) -> int:
    """Heuristic frontier cap: the widest compact level whose per-feature
    histogram slab (cap * n_bins * channels f32) stays within a ~4 MiB
    working set, clamped to what the tree can actually populate
    (min(2^depth, N) live nodes) and floored at 64 slots so shallow/fat
    configurations don't thrash the multi-pass frontier loop.  Rounded to a
    multiple of 64 for tidy lane alignment.  Perf-only: any cap builds the
    same forest bit-for-bit."""
    budget = (1 << 22) // max(1, n_bins * n_stat_channels * 4)
    budget = max(64, (budget // 64) * 64)
    return int(min(2 ** max_depth, max(64, n_samples), budget))


def auto_trees_per_batch(n_samples: int, n_estimators: int,
                         n_bins: int) -> int:
    """Heuristic bagging batch, the same value the JAX package derives:
    the per-batch row working set (~N * n_bins lanes per tree) stays within
    a ~4 MiB budget, capped at 8 and at the forest size.  Perf-only:
    batching never touches per-tree randomness, so outputs are
    bit-identical at any setting."""
    per_tree = max(1, n_samples * n_bins)
    return int(max(1, min(n_estimators, 8, (1 << 22) // per_tree)))
