"""FederatedForest — the user-facing estimator (fit/predict).

Orchestrates: master-side randomness (bootstrap weights + per-tree feature
subsets, paper Alg. 2 lines 3–4), label encoding (crypto.py), tree building
(tree.py) and the one-round predictor (prediction.py), through a federation
substrate (the simulated one by default).

The centralized baseline ("NonFF") is *the same code* with M = 1 — that is the
strongest possible form of the paper's losslessness claim, and it's what the
tests assert bit-identically.

``fit_resumable`` is the paper's break-point recovery (§4.1): tree chunks
checkpointed in the JAX package's format (ckpt/checkpoint.py), so a fit
resumes — in either package — where the last complete chunk ended.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import crypto, impurity
from repro_torch.core.party import VerticalPartition, make_vertical_partition
from repro_torch.core.tree import PartyTree
from repro_torch.core.types import ForestParams
from repro_torch.device import resolve_device
from repro_torch.observability import registry as telemetry
from repro_torch.observability import trace as tracing

# bytes of host arrays a fit makes into device operands, bound once
_M_STAGED = telemetry.REGISTRY.counter("forest.staged_bytes")


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

    def _operand(self, a):
        """A program operand: a tensor on ``self.device`` — or, on a
        substrate whose parties live in their own processes, the host array
        itself, which goes to the wire as it is (the session process puts
        no party data on the card only to copy it back)."""
        if getattr(self._sub(), "host_operands", False):
            return np.asarray(a)
        return torch.as_tensor(a, device=self.device)

    def _fitted(self, trees) -> PartyTree:
        """A fit program's PartyTree stack on ``self.device`` (the
        party-per-process substrate returns host arrays)."""
        if torch.is_tensor(trees.is_leaf):
            return trees
        from repro_torch import convert
        return convert.party_trees_from_numpy(trees, self.device)

    # ------------------------------------------------------------------ fit
    def fit(self, partition: VerticalPartition, y: np.ndarray) -> "FederatedForest":
        with tracing.TRACER.span("fit.prepare", rows=partition.n_samples,
                                 trees=self.params.n_estimators):
            run, xb, feat_gid, weights, feat_sels, y_stats = self._prepare(
                partition, y)
        self.trees_ = self._fitted(run(xb, feat_gid, feat_sels, weights,
                                       y_stats))
        self.partition_ = partition
        return self

    def _prepare(self, partition: VerticalPartition, y: np.ndarray):
        """Set-up shared by ``fit`` and ``fit_resumable``: resolve the
        params, encode the labels, draw the master randomness and stage the
        binned data, labels and draws as operands.  Returns the fit program
        and its inputs (the per-tree ``weights``/``feat_sels`` lead with
        the tree axis, so a caller can slice them by tree)."""
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

        with tracing.TRACER.span("fit.randomness", trees=p.n_estimators,
                                 bootstrap=p.bootstrap):
            weights, feat_sels = self._master_randomness(partition)
        run = programs.forest_fit_program(self._sub(), p)
        # the operands' copies; the counter takes the bytes made into
        # device operands (none on a substrate that takes host operands)
        host = (partition.xb, partition.feat_gid, y_enc, weights, feat_sels)
        with tracing.TRACER.span("fit.stage") as span:
            ops = tuple(self._operand(a) for a in host)
            staged = sum(a.nbytes for a, op in zip(host, ops)
                         if isinstance(a, np.ndarray) and torch.is_tensor(op))
            _M_STAGED.inc(staged)
            span.set(bytes=staged)
        xb, feat_gid, y_op, weights, feat_sels = ops
        y_stats = impurity.stat_channels(torch.as_tensor(y_op), p.task,
                                         p.n_classes)
        return (run, xb, feat_gid, weights, feat_sels,
                self._operand(y_stats))

    def _master_randomness(self, partition: VerticalPartition):
        """Paper Alg. 2: master samples rows (bootstrap) + per-tree features.

        Each tree draws from its own seeded NumPy stream
        (``default_rng([seed, t])``), exactly as the JAX package does, so
        both packages grow the same trees; tree t's draws depend only on
        (seed, t).  The arrays are staged as operands by the caller."""
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

    def _fit_fingerprint(self, partition: VerticalPartition,
                         y: np.ndarray) -> str:
        """Content hash of everything a resumable fit depends on EXCEPT the
        tree count: the binned data, the labels, and the params — the JAX
        package's hash, byte for byte, so either package resumes the
        other's checkpoints.  A checkpoint tagged with a different
        fingerprint must not be resumed: appending rows (ingest_append)
        changes the partition, and welding old-data trees onto new-data
        trees would silently produce a franken-forest.  n_estimators is
        excluded so growing the tree count IS resumable (per-tree
        randomness makes the prefix exact).  The device is not part of it:
        a checkpoint written on the CPU resumes on the card.  One case
        differs from the JAX hash on purpose: masked regression (below)."""
        h = hashlib.sha256()
        for a in (partition.xb, partition.feat_gid, partition.boundaries,
                  np.asarray(y)):
            h.update(np.ascontiguousarray(a).tobytes())
        h.update(repr(dataclasses.replace(
            self.params, n_estimators=0)).encode())
        h.update(repr((self.encrypt_labels, self.mask_regression)).encode())
        if self.mask_regression and self.params.task == "regression":
            # the JAX package's fit_resumable trains this case on UNMASKED
            # targets under the hash above; the port trains masked trees,
            # so neither package may resume the other's checkpoint here
            h.update(b"masked-regression-trees")
        return h.hexdigest()

    # -------------------------------------------------------------- predict
    def _run_predict(self, x_test: np.ndarray, program, *shared) -> np.ndarray:
        from repro_torch.federation import programs
        if self.trees_ is None:
            raise ValueError("model is not fitted: call fit() first")
        xb_parts = self.partition_.bin_test(np.asarray(x_test))
        out = program(self.trees_, self._operand(xb_parts), *shared)
        return self._decode(programs.party0(out))

    def predict(self, x_test: np.ndarray) -> np.ndarray:
        """One-round prediction (the paper's algorithm)."""
        from repro_torch.federation import programs
        return self._run_predict(
            x_test, programs.forest_predict_program(self._sub(), self.params))

    def predict_classical(self, x_test: np.ndarray) -> np.ndarray:
        """Multi-round baseline (the paper's comparison in Figs. 4-6)."""
        from repro_torch.federation import programs
        return self._run_predict(
            x_test,
            programs.forest_predict_classical_program(self._sub(), self.params))

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

    # ------------------------------------------------- break-point recovery
    def fit_resumable(self, partition: VerticalPartition, y: np.ndarray,
                      ckpt_dir: str, trees_per_chunk: int = 2) -> "FederatedForest":
        """Paper §4.1: "if the connection is down, the modeling can be easily
        recovered from the break point."  Trees are independent (bagging), so
        recovery granularity = tree chunks: each chunk's PartyTree stack is
        checkpointed; a restarted fit resumes after the last complete chunk
        and produces the IDENTICAL forest (master randomness is derived from
        the seed, not from progress, and the histogram's launch layout
        depends on N, B and C only, never on which trees share a launch).

        Checkpoints carry a fingerprint of (binned data, labels, params sans
        tree count): a checkpoint from different data or params is ignored
        and the fit restarts from scratch instead of welding incompatible
        tree prefixes together.  Two incremental moves are therefore exact:

          * **more trees** — rerun with a larger ``n_estimators``: the
            checkpointed prefix is reused and only the new trees build;
          * **more rows** — after ``Federation.ingest_append`` the partition
            changed, the fingerprint mismatches, and the refit is cleanly
            from scratch on the concatenated data.

        A checkpoint AHEAD of ``n_estimators`` (trained further in a prior
        run) restores and slices its first ``n_estimators`` trees — also
        exact, for the same reason.  The trees stay on ``self.device``;
        they go to host NumPy only to be written."""
        from repro_torch import ckpt
        from repro_torch.serving.engine import load_forest_trees
        run, xb, feat_gid, weights, feat_sels, y_stats = self._prepare(
            partition, y)
        p = self.params
        dev = self.device
        fingerprint = self._fit_fingerprint(partition, y)

        chunks: list = []
        done = ckpt.latest_step(ckpt_dir)
        if done is not None:
            # checkpoints without a fingerprint are trusted as before; a
            # PRESENT-but-different fingerprint means the data or params
            # moved under the checkpoint — start over
            stamp = ckpt.read_meta(ckpt_dir, done).get("fingerprint")
            if stamp is not None and stamp != fingerprint:
                done = None
        start = 0
        if done is not None and done >= p.n_estimators:
            full = load_forest_trees(ckpt_dir, done, device=dev)
            self.trees_ = PartyTree(*(a[:, : p.n_estimators] for a in full))
            self.partition_ = partition
            return self
        if done is not None:
            chunks.append(load_forest_trees(ckpt_dir, done, device=dev))
            start = done
        for lo in range(start, p.n_estimators, trees_per_chunk):
            hi = min(lo + trees_per_chunk, p.n_estimators)
            part_trees = self._fitted(run(
                xb, feat_gid, feat_sels[lo:hi], weights[lo:hi], y_stats))
            chunks.append(part_trees)
            merged = PartyTree(*(torch.cat(fs, dim=1) for fs in zip(*chunks)))
            ckpt.save_checkpoint(ckpt_dir, hi, merged,
                                 meta={"family": "forest",
                                       "fingerprint": fingerprint})
            chunks = [merged]
        self.trees_ = chunks[0]
        self.partition_ = partition
        return self

    # ------------------------------------------------------------ inspection
    def feature_importance(self, view: str = "master") -> np.ndarray:
        """Split-count importance over encoded feature ids (privacy-aware:
        ``view='party:i'`` restricts to party i's own splits — what each
        participant may legitimately compute locally)."""
        if self.trees_ is None:
            raise ValueError("model is not fitted: call fit() first")
        trees = PartyTree(*(a.detach().cpu().numpy() for a in self.trees_))
        counts = np.zeros(self.partition_.n_features, np.float64)
        gids = trees.split_gid[0]             # master view (T, nn)
        weights = trees.leaf_stats[0].sum(-1)  # node weighted counts (T, nn)
        if view.startswith("party:"):
            i = int(view.split(":")[1])
            mine = trees.has_split[i]
            gids = np.where(mine, gids, -1)
        sel = gids >= 0
        np.add.at(counts, gids[sel], weights[sel])
        total = counts.sum()
        return counts / total if total else counts

    def master_tree_view(self) -> dict[str, np.ndarray]:
        """The complete model T as the master stores it (owner + encoded id)."""
        if self.trees_ is None:
            raise ValueError("model is not fitted: call fit() first")
        t = PartyTree(*(a[0].detach().cpu().numpy() for a in self.trees_))
        return {"owner": t.owner, "split_gid": t.split_gid,
                "is_leaf": t.is_leaf, "leaf_stats": t.leaf_stats}


def fit_federated_forest(x: np.ndarray, y: np.ndarray, n_parties: int,
                         params: ForestParams, *, contiguous: bool = True,
                         **forest_kw) -> FederatedForest:
    """Convenience: vertical-partition a raw matrix and fit (``device`` in
    ``forest_kw``, the card by default)."""
    part = make_vertical_partition(x, n_parties, params.n_bins,
                                   contiguous=contiguous, seed=params.seed)
    return FederatedForest(params, **forest_kw).fit(part, y)
