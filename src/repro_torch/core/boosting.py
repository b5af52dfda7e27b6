"""Federated gradient boosting (beyond the paper, SecureBoost-style).

The same vertical-federated split protocol builds boosted trees: boosting
only changes the stat channels from class counts to (hessian, gradient)
sums and the leaf values to a Newton step.  Each round fits ONE regression
tree through the forest's fit program on the stats
``(hh, hh·pseudo, hh·pseudo²)`` — float stats with a signed middle channel,
through the histogram kernel's float route — and predicts it on the
training rows with the one-round predictor.

Copied from the JAX package as written, because that is where the two
would part:

  * ``hh = h + λ/n``: the ridge term is folded into every sample's hessian,
    so a leaf's value is −G / (H + λ·n_leaf/n), not −G/(H+λ);
  * the gradients, hessians and pseudo-targets are float64 NumPy, cast to
    float32 only when stacked into the stats; the running margin ``f_cur``
    stays a float64 host array;
  * ``min_samples_leaf`` is tested against channel 0, which here is Σhh,
    not a sample count;
  * every round passes an all-true feature selection and unit weights: no
    master randomness, no bootstrap.

Supported: squared-error regression and binary logistic classification.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core.party import VerticalPartition
from repro_torch.core.tree import PartyTree
from repro_torch.core.types import ForestParams
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class BoostParams:
    task: str = "regression"            # "regression" | "binary"
    n_rounds: int = 20
    learning_rate: float = 0.2
    max_depth: int = 4
    min_samples_leaf: int = 1
    n_bins: int = 32
    reg_lambda: float = 1.0
    seed: int = 0
    # plumbed into the per-round tree build (see ForestParams)
    hist_impl: str = "auto"
    frontier_cap: int = 256

    def tree_params(self) -> ForestParams:
        # gradient trees: the regression channels (w, wy, wy²) with
        # w = hessian and y = -g/h (see fit); the variance-reduction gain
        # is the Newton gain up to constants
        return ForestParams(task="regression", n_estimators=1,
                            max_depth=self.max_depth,
                            min_samples_leaf=self.min_samples_leaf,
                            n_bins=self.n_bins, bootstrap=False,
                            seed=self.seed, hist_impl=self.hist_impl,
                            frontier_cap=self.frontier_cap)


def stack_rounds(trees: list[PartyTree]) -> PartyTree:
    """Stack per-round PartyTrees (each (M, 1, ...)) into one (M, R, ...)
    PartyTree along the tree dim — the layout ``Federation.save``
    checkpoints."""
    if not trees:
        raise ValueError("no fitted rounds to stack")
    if len(trees) == 1:
        return trees[0]
    return PartyTree(*(torch.cat(fs, dim=1) for fs in zip(*trees)))


def split_rounds(stack: PartyTree) -> list[PartyTree]:
    """Inverse of :func:`stack_rounds`: (M, R, ...) -> R (M, 1, ...) trees
    (``Federation.load`` rebuilds the per-round list from a checkpoint)."""
    r = int(stack.is_leaf.shape[1])
    return [PartyTree(*(a[:, i:i + 1] for a in stack)) for i in range(r)]


class RoundProgram(NamedTuple):
    """The per-round fit program and its inputs that stay fixed over a fit,
    on the device."""
    run: Callable          # fn(xb, feat_gid, feat_sel, weights, stats)
    xb: torch.Tensor       # (M, N, Fp) party bins
    feat_gid: torch.Tensor
    sel: torch.Tensor      # (1, F) all true: no master feature sampling
    w: torch.Tensor        # (1, N) ones: no bootstrap


@dataclasses.dataclass
class FederatedBoosting:
    params: BoostParams
    # execution substrate (federation.substrate); None -> simulated
    substrate: Any = None
    # where the rounds are fitted and predicted: None -> the CUDA card
    device: torch.device | str | None = None
    trees_: list = dataclasses.field(default_factory=list)  # PartyTree per round
    base_: float = 0.0

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)

    def _sub(self):
        from repro_torch.federation.substrate import default_substrate
        return default_substrate(self.substrate)

    def _predict_runner(self):
        """The per-round predict program — built in fit, or lazily for
        models rebuilt from a checkpoint (``Federation.load``)."""
        if getattr(self, "_pred_run", None) is None:
            from repro_torch.federation import programs
            self._pred_run = programs.forest_predict_program(
                self._sub(), self.params.tree_params(), tree_sharded=False)
        return self._pred_run

    def fit(self, partition: VerticalPartition, y: np.ndarray):
        from repro_torch.federation import programs
        p = self.params
        y = np.asarray(y, np.float64)
        n = partition.n_samples
        if p.task == "binary":
            pos = np.clip(y.mean(), 1e-6, 1 - 1e-6)
            self.base_ = float(np.log(pos / (1 - pos)))
        else:
            self.base_ = float(y.mean())
        f_cur = np.full(n, self.base_)

        prog = self._round_program(partition)
        self.trees_ = []
        for _ in range(p.n_rounds):
            trees = self._fit_round(prog, y, f_cur)
            self.trees_.append(trees)
            step = programs.party0(self._pred_run(trees, prog.xb))
            f_cur = f_cur + p.learning_rate * step
        self._partition = partition
        return self

    def _round_program(self, partition: VerticalPartition) -> RoundProgram:
        """The fit program and its fixed inputs, built once per fit (the
        predict program too, onto ``_pred_run``)."""
        from repro_torch.federation import programs
        tp = self.params.tree_params()
        dev = self.device
        sub = self._sub()
        # one tree per round: never shard the T=1 args over a "trees" axis
        self._pred_run = programs.forest_predict_program(sub, tp,
                                                         tree_sharded=False)
        return RoundProgram(
            programs.forest_fit_program(sub, tp, tree_sharded=False),
            torch.as_tensor(partition.xb, device=dev),
            torch.as_tensor(partition.feat_gid, device=dev),
            torch.ones((1, partition.n_features), dtype=torch.bool,
                       device=dev),
            torch.ones((1, partition.n_samples), dtype=torch.float32,
                       device=dev))

    def _fit_round(self, prog: RoundProgram, y: np.ndarray,
                   f_cur: np.ndarray) -> PartyTree:
        """One round's tree, fitted to the Newton step at the margin
        ``f_cur`` (float64, on the host)."""
        g, h = self._grad_hess(y, f_cur)
        # regression channels on the Newton pseudo-target: w = h,
        # y_pseudo = -g/h  =>  leaf mean = -G/H (the ridge term rides in h
        # as reg_lambda / n per sample)
        hh = h + self.params.reg_lambda / max(len(y), 1)
        pseudo = -g / hh
        stats = np.stack([hh.astype(np.float32),
                          (hh * pseudo).astype(np.float32),
                          (hh * pseudo * pseudo).astype(np.float32)], axis=-1)
        trees = prog.run(prog.xb, prog.feat_gid, prog.sel, prog.w,
                         torch.as_tensor(stats, device=prog.xb.device))
        if torch.is_tensor(trees.is_leaf):
            return trees
        # the party-per-process substrate answers with host arrays
        from repro_torch import convert
        return convert.party_trees_from_numpy(trees, self.device)

    def _grad_hess(self, y, f):
        if self.params.task == "binary":
            prob = 1.0 / (1.0 + np.exp(-f))
            return prob - y, np.maximum(prob * (1 - prob), 1e-6)
        return f - y, np.ones_like(y)

    def decision_function(self, x_test: np.ndarray) -> np.ndarray:
        from repro_torch.federation import programs
        if not self.trees_:
            raise ValueError("model is not fitted: call fit() first")
        xb = torch.as_tensor(self._partition.bin_test(np.asarray(x_test)),
                             device=self.device)
        f = np.full(x_test.shape[0], self.base_)
        run = self._predict_runner()
        for trees in self.trees_:
            f = f + self.params.learning_rate * programs.party0(run(trees, xb))
        return f

    def predict(self, x_test: np.ndarray) -> np.ndarray:
        f = self.decision_function(x_test)
        if self.params.task == "binary":
            return (f > 0).astype(np.int64)
        return f
