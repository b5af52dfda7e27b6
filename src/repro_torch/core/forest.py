"""FederatedForest — the user-facing estimator (fit/predict).

Orchestrates: master-side randomness (bootstrap weights + per-tree feature
subsets, paper Alg. 2 lines 3–4), label encoding (crypto.py), tree building
(tree.py) and the one-round predictor (prediction.py), through a federation
substrate (the simulated one by default).

The centralized baseline ("NonFF") is *the same code* with M = 1 — that is the
strongest possible form of the paper's losslessness claim, and it's what the
tests assert bit-identically.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import crypto, impurity
from repro_torch.core.party import VerticalPartition
from repro_torch.core.tree import PartyTree
from repro_torch.core.types import ForestParams
from repro_torch.device import resolve_device


@dataclasses.dataclass
class FederatedForest:
    params: ForestParams
    encrypt_labels: bool = True
    # Regression-target masking is opt-in: the affine mask preserves split
    # gains exactly in real arithmetic but not in float32, so it trades
    # exact losslessness for in-transit privacy (paper §4.3).
    mask_regression: bool = False
    # execution substrate (federation.substrate); None -> simulated
    substrate: Any = None
    # where the forest is fitted and predicted: None -> the CUDA card
    device: torch.device | str | None = None

    # fitted state
    trees_: PartyTree | None = None      # leading axes (M, T, ...)
    partition_: VerticalPartition | None = None
    _decode: Callable | None = None

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)

    def _sub(self):
        from repro_torch.federation.substrate import default_substrate
        return default_substrate(self.substrate)

    # ------------------------------------------------------------------ fit
    def fit(self, partition: VerticalPartition, y: np.ndarray) -> "FederatedForest":
        from repro_torch.federation import programs
        # "auto" build knobs resolve against the actual training set — the
        # concrete values land back on self.params so refits see them
        self.params = self.params.resolved(partition.n_samples)
        p = self.params
        if partition.xb.shape[2] == 0:
            raise ValueError("empty feature space")
        y = np.asarray(y)
        if self.encrypt_labels and p.task == "classification":
            y_enc, self._decode = crypto.encode_labels(y, p.n_classes, p.seed)
        elif self.mask_regression and p.task == "regression":
            y_enc, self._decode = crypto.mask_regression_targets(y, p.seed)
        else:
            y_enc, self._decode = y, lambda v: np.asarray(v)

        dev = self.device
        y_stats = impurity.stat_channels(torch.as_tensor(y_enc, device=dev),
                                         p.task, p.n_classes)
        weights, feat_sels = self._master_randomness(partition)
        run = programs.forest_fit_program(self._sub(), p)
        self.trees_ = run(torch.as_tensor(partition.xb, device=dev),
                          torch.as_tensor(partition.feat_gid, device=dev),
                          torch.as_tensor(feat_sels, device=dev),
                          torch.as_tensor(weights, device=dev), y_stats)
        self.partition_ = partition
        return self

    def _master_randomness(self, partition: VerticalPartition):
        """Paper Alg. 2: master samples rows (bootstrap) + per-tree features.

        Each tree draws from its own seeded NumPy stream
        (``default_rng([seed, t])``), exactly as the JAX package does, so
        both packages grow the same trees; tree t's draws depend only on
        (seed, t).  The arrays are copied to the device by the caller."""
        p = self.params
        n, f = partition.n_samples, partition.n_features
        t = p.n_estimators
        k = max(1, int(np.ceil(p.max_features * f)))
        weights = np.ones((t, n))
        feat_sels = np.zeros((t, f), dtype=bool)
        for i in range(t):
            rng = np.random.default_rng([p.seed, i])
            if p.bootstrap:
                weights[i] = np.bincount(rng.integers(0, n, size=n),
                                         minlength=n)
            feat_sels[i, rng.choice(f, size=k, replace=False)] = True
        return weights.astype(np.float32), feat_sels

    # -------------------------------------------------------------- predict
    def _run_predict(self, x_test: np.ndarray, program, *shared) -> np.ndarray:
        from repro_torch.federation import programs
        if self.trees_ is None:
            raise ValueError("model is not fitted: call fit() first")
        xb_parts = self.partition_.bin_test(np.asarray(x_test))
        out = program(self.trees_, torch.as_tensor(xb_parts, device=self.device),
                      *shared)
        return self._decode(programs.party0(out))

    def predict(self, x_test: np.ndarray) -> np.ndarray:
        """One-round prediction (the paper's algorithm)."""
        from repro_torch.federation import programs
        return self._run_predict(
            x_test, programs.forest_predict_program(self._sub(), self.params))

    def leaf_table(self, pad_multiple: int = 8):
        """Live-leaf compaction plan of the fitted forest (serving/plan.py)."""
        from repro_torch.serving import plan
        if self.trees_ is None:
            raise ValueError("model is not fitted: call fit() first")
        return plan.build_leaf_table(self.trees_, self.params,
                                     pad_multiple=pad_multiple)

    def predict_compact(self, x_test: np.ndarray,
                        leaf_table=None) -> np.ndarray:
        """One-round prediction through the leaf-compacted mask.

        Bit-identical to :meth:`predict` (Prop. 1 is unchanged; only dead
        heap columns are dropped from the party sum and the vote)."""
        from repro_torch.federation import programs
        if self.trees_ is None:
            raise ValueError("model is not fitted: call fit() first")
        lt = leaf_table if leaf_table is not None else self.leaf_table()
        return self._run_predict(
            x_test,
            programs.forest_predict_program(self._sub(), self.params,
                                            compact=True),
            lt.leaf_idx)
