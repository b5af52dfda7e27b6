"""Federation — the session object that owns the federated lifecycle.

The paper's system is one coordinated protocol: regional clients join a
session, train jointly (Alg. 2), and answer predictions with one round of
communication (Alg. 5/6)::

    fed = Federation(parties=2)                 # on the CUDA card
    part = fed.ingest(x_train, y_train)         # vertical partition + binning
    model = fed.fit(ForestParams(...))          # FittedModel (Estimator)
    preds = fed.predict(model, x_test)          # one-round, leaf-compacted

``predict`` caches the LeafTable compaction plan per model and rebuilds it
whenever the model's ``trees_`` changes, so a plan never goes stale against
a refitted model.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core.forest import FederatedForest
from repro_torch.core.party import VerticalPartition, make_vertical_partition
from repro_torch.core.types import ForestParams
from repro_torch.device import resolve_device
from repro_torch.federation.estimator import Estimator
from repro_torch.federation.substrate import resolve_substrate


class Federation:
    """A federated-learning session: participants + substrate + lifecycle.

    Args:
      parties: number of participating parties M (the vertical split width).
      substrate: "simulated" (the default and, so far, the only one) or a
        pre-built substrate.
      hist_impl: session-level histogram backend override — folded into
        every spec this session fits (None defers to the spec's own
        ``hist_impl``).
      n_bins: default quantile-bin count for :meth:`ingest`.
      seed: default partitioning seed for :meth:`ingest`.
      device: where fit and predict run.  None means the CUDA card, and
        raises on a host without one; pass "cpu" to run on the CPU.
    """

    def __init__(self, parties: int = 2, substrate: Any = "simulated",
                 hist_impl: str | None = None, n_bins: int = 32,
                 seed: int = 0, device: torch.device | str | None = None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # the forest vote sums leaf counts in a matrix product: keep it
            # in full float32 (prediction._check_full_f32 asserts it)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.set_float32_matmul_precision("highest")
        self.parties = int(parties)
        self.hist_impl = hist_impl
        self.n_bins = int(n_bins)
        self.seed = int(seed)
        self.substrate = resolve_substrate(substrate)
        self._partition: VerticalPartition | None = None
        self._y: np.ndarray | None = None
        # id(model) -> (model, trees_ ref, LeafTable): the plan is valid
        # exactly while the model still holds that PartyTree stack
        self._plans: dict[int, tuple[Any, Any, Any]] = {}

    # ------------------------------------------------------------------ data
    def ingest(self, x: np.ndarray, y: np.ndarray | None = None, *,
               n_bins: int | None = None, contiguous: bool = True,
               seed: int | None = None) -> VerticalPartition:
        """Ingest the session's training set: a centrally held, pre-aligned
        raw (N, F) matrix split across the session's M parties, each binning
        its own columns.  Remembers (partition, y) so ``fit(spec)`` needs no
        further arguments."""
        part = make_vertical_partition(
            np.asarray(x), self.parties, n_bins or self.n_bins,
            contiguous=contiguous, seed=self.seed if seed is None else seed)
        self._partition = part
        self._y = None if y is None else np.asarray(y)
        return part

    # ------------------------------------------------------------------- fit
    def fit(self, spec: ForestParams, partition: VerticalPartition | None = None,
            y: np.ndarray | None = None, **model_kw) -> Estimator:
        """Train the forest ``spec`` describes on this session's substrate
        and device; returns the fitted handle."""
        if not isinstance(spec, ForestParams):
            raise TypeError(f"unknown model spec {type(spec).__name__} "
                            f"(expected ForestParams)")
        partition, y = self._training_set(partition, y)
        self._check_binning(spec, partition)
        model = FederatedForest(self._apply_session(spec),
                                substrate=self.substrate, device=self.device,
                                **model_kw)
        return model.fit(partition, y)

    def _training_set(self, partition, y):
        partition = partition if partition is not None else self._partition
        y = y if y is not None else self._y
        if partition is None or y is None:
            raise ValueError("no training data: call ingest(x, y) first or "
                             "pass (partition, y) explicitly")
        if partition.n_parties != self.parties:
            raise ValueError(f"partition has {partition.n_parties} parties, "
                             f"session declares {self.parties}")
        return partition, y

    @staticmethod
    def _check_binning(spec, partition):
        """A spec binned differently from the partition would histogram
        truncated bin ids and silently train a wrong model — reject it."""
        if spec.n_bins != partition.n_bins:
            raise ValueError(
                f"spec.n_bins={spec.n_bins} but the partition was ingested "
                f"with n_bins={partition.n_bins}; re-ingest with matching "
                f"bins (Federation(n_bins=...) or ingest(n_bins=...))")

    def _apply_session(self, spec: ForestParams) -> ForestParams:
        """Fold session-level settings into a spec (hist_impl is owned here)."""
        if self.hist_impl is not None:
            spec = dataclasses.replace(spec, hist_impl=self.hist_impl)
        return spec

    # --------------------------------------------------------------- predict
    def predict(self, model: FederatedForest, x_test: np.ndarray) -> np.ndarray:
        """One-round prediction through the leaf-compacted mask, with a
        per-model cached LeafTable plan, rebuilt automatically when
        ``model.trees_`` changed since the plan was made."""
        return model.predict_compact(x_test, leaf_table=self._plan_for(model))

    def _plan_for(self, model):
        """The model's LeafTable — cached until its trees_ is swapped out."""
        cached = self._plans.get(id(model))
        if cached is not None and cached[0] is model \
                and cached[1] is model.trees_:
            return cached[2]
        table = model.leaf_table()
        self._plans[id(model)] = (model, model.trees_, table)
        return table
