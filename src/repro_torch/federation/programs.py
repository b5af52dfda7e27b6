"""Substrate-specialized forest programs (the fit/predict closures).

  * fit:      party args (xb, feat_gid), shared (feat_sel, weights, y_stats).
    Under a sharded mesh the per-tree shared args and the PartyTree output
    split over the "trees" axis (bagging tree-parallelism).
  * predict:  the paper's one-round protocol.  In process and party per
    process, the result is the shared forest output every party computes.
    Sharded, every rank returns its tree shard's per-tree outputs
    (``aggregate=False``) and the forest vote over all shards is the
    session-side reduction (``prediction.forest_vote``) — the JAX
    package's cross-shard reduction.
  * boosting predict: the same protocol over a stack of rounds, reduced to
    ``base + lr·Σ rounds`` in the same program.
  * linear predict: F-LR's joint logit (one sum over the parties).
  * classical predict: the multi-round baseline (one sum per level).

Forest fit/predict and linear predict carry a ``distributed=`` protocol
spec (federation/distributed.py), which the party-per-process and sharded
substrates run and the simulated one ignores; boosting and classical
predict carry a rank-only ``sharded=`` spec (federation/sharded.py).
Boosting and classical predict have no party-per-process body, so on that
substrate they raise NotImplementedError, as in the JAX package.

``party0`` normalizes the output conventions (a per-party stack, or the
already-reduced shared result) to the master-side host array.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import fedlinear, prediction, tree
from repro_torch.core.types import ForestParams


def party0(out) -> np.ndarray:
    """Master-side view of a program output as a host array: a per-party
    stack gives its row 0 (the shared result), a shared result is itself."""
    out = out.detach().cpu().numpy() if torch.is_tensor(out) else np.asarray(out)
    return out[0] if out.ndim > 1 else out


def forest_fit_program(substrate, params: ForestParams,
                       hist_impl: str | None = None, *,
                       tree_sharded: bool = True):
    """fn(xb, feat_gid, feat_sel, weights, y_stats) -> PartyTree stack.

    ``tree_sharded=False`` keeps the per-tree args/outputs replicated across
    a mesh's "trees" axis — for callers whose tree count doesn't divide it
    (boosting fits one tree per round)."""
    if params.needs_resolution:
        raise ValueError(
            "frontier_cap/trees_per_batch='auto' resolve at fit time from "
            "the training set; pass params.resolved(n_samples) to build a "
            "program directly")
    from repro_torch.federation import distributed
    fit_fn = functools.partial(tree.build_forest, params=params,
                               hist_impl=hist_impl)
    tree_ax = getattr(substrate, "tree_axis", None) if tree_sharded else None
    return substrate.program(
        fit_fn, 2, 3,
        distributed=distributed.forest_fit_spec(params, hist_impl),
        shared_specs=(tree_ax, tree_ax, None), out_specs=tree_ax)


def forest_predict_program(substrate, params: ForestParams, *,
                           compact: bool = False,
                           mask_dtype: torch.dtype = torch.int32,
                           vote_impl: str = "einsum",
                           tree_sharded: bool = True, parties=None):
    """fn(trees, xb_test[, leaf_idx]) — the one-round forest prediction.

    ``compact=True`` adds the LeafTable's ``leaf_idx`` as a trailing shared
    arg (bit-identical outputs; party sum and vote over live leaves only).
    ``tree_sharded=False``: see forest_fit_program.  ``parties`` restricts
    the protocol to a subset of party indices — the distributed substrate's
    degraded-serving path (in-process and sharded substrates always run
    every party and ignore it)."""
    from repro_torch.federation import distributed

    def fn(trees, xbt, *shared):
        return prediction.forest_predict_oneround(
            trees, xbt, params, aggregate=True, mask_dtype=mask_dtype,
            vote_impl=vote_impl, leaf_idx=shared[0] if shared else None)
    n_shared = 1 if compact else 0
    if getattr(substrate, "mesh", None) is not None:
        # sharded: trees split over (parties, trees); each rank emits its
        # shard's per-tree outputs and the forest vote reduces across
        # shards, in the session
        from repro_torch.federation import sharded
        tree_ax = substrate.tree_axis if tree_sharded else None
        inner = substrate.program(
            fn, 2, n_shared,
            sharded=sharded.forest_predict_trees_spec(
                params, compact=compact, mask_dtype=mask_dtype,
                vote_impl=vote_impl),
            party_specs=(tree_ax, None), shared_specs=(tree_ax,) * n_shared,
            out_specs=tree_ax)
        return sharded.Reduced(inner, functools.partial(
            sharded.forest_vote, params=params, device=substrate.device))
    return substrate.program(
        fn, 2, n_shared,
        distributed=distributed.forest_predict_spec(
            params, compact=compact, mask_dtype=mask_dtype,
            vote_impl=vote_impl),
        parties=parties)


def boosting_predict_program(substrate, params, *, compact: bool = False,
                             mask_dtype: torch.dtype = torch.uint8):
    """fn(trees, xbt, base[, leaf_idx]) — one-wave boosting prediction.

    ``trees`` is the per-round PartyTree stack (leading (M, R, ...) dims,
    core.boosting.stack_rounds); the one-round membership protocol runs with
    ``aggregate=False`` per-round outputs and the boosting reduction
    (base + lr * Σ rounds, thresholded for the binary task) runs in the same
    program — ONE party sum for the whole ensemble, as for the forest.
    ``params`` is a BoostParams; ``base`` is a shared scalar argument."""
    tp = params.tree_params()
    lr, task = params.learning_rate, params.task

    def fn(trees, xbt, base, *shared):
        per_round = prediction.forest_predict_oneround(
            trees, xbt, tp, aggregate=False, mask_dtype=mask_dtype,
            leaf_idx=shared[0] if shared else None)          # (R, N)
        f = base + lr * per_round.sum(0)
        if task == "binary":
            return (f > 0).to(torch.int32)
        return f
    from repro_torch.federation import sharded
    return substrate.program(
        fn, 2, 2 if compact else 1,
        sharded=sharded.boosting_predict_spec(params, compact=compact,
                                              mask_dtype=mask_dtype))


def linear_predict_program(substrate, task: str):
    """fn(x, w, b) — the F-LR joint-logit prediction (one party sum).

    ``x`` and ``w`` are party args (each party's standardized feature block
    and its weight block, stacked on dim 0); the bias ``b`` is shared."""
    from repro_torch.federation import distributed

    def fn(x, w, b):
        return fedlinear._spmd_predict(x, w, b, task=task)
    return substrate.program(fn, 2, 1,
                             distributed=distributed.linear_predict_spec(task))


def forest_predict_classical_program(substrate, params: ForestParams):
    """fn(trees, xb_test) — the multi-round baseline (paper Figs. 4-6).

    Sharded, as for the one-round predict: every rank returns its tree
    shard's per-tree outputs (one party sum per level, rank to rank) and
    the forest vote runs in the session."""
    def fn(trees, xbt):
        return prediction.forest_predict_classical(trees, xbt, params)
    if getattr(substrate, "mesh", None) is not None:
        from repro_torch.federation import sharded
        inner = substrate.program(
            fn, 2, 0, sharded=sharded.forest_predict_classical_spec(params),
            party_specs=(substrate.tree_axis, None),
            out_specs=substrate.tree_axis)
        return sharded.Reduced(inner, functools.partial(
            sharded.forest_vote, params=params, device=substrate.device))
    return substrate.program(fn, 2, 0)
