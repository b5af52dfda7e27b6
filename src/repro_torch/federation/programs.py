"""Substrate-specialized forest programs (the fit/predict closures).

  * fit:      party args (xb, feat_gid), shared (feat_sel, weights, y_stats).
  * predict:  the paper's one-round protocol; the result is the shared
    forest output every party computes.
  * boosting predict: the same protocol over a stack of rounds, reduced to
    ``base + lr·Σ rounds`` in the same program.
  * linear predict: F-LR's joint logit (one sum over the parties).
  * classical predict: the multi-round baseline (one sum per level).

Forest fit/predict and linear predict carry a ``distributed=`` protocol
spec (federation/distributed.py), which the party-per-process substrate
runs and the simulated one ignores; boosting and classical predict have
none, so on that substrate they raise NotImplementedError, as in the JAX
package.

``party0`` normalizes a program output to the master-side host array.
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
                       hist_impl: str | None = None):
    """fn(xb, feat_gid, feat_sel, weights, y_stats) -> PartyTree stack."""
    if params.needs_resolution:
        raise ValueError(
            "frontier_cap/trees_per_batch='auto' resolve at fit time from "
            "the training set; pass params.resolved(n_samples) to build a "
            "program directly")
    from repro_torch.federation import distributed
    fit_fn = functools.partial(tree.build_forest, params=params,
                               hist_impl=hist_impl)
    return substrate.program(
        fit_fn, 2, 3,
        distributed=distributed.forest_fit_spec(params, hist_impl))


def forest_predict_program(substrate, params: ForestParams, *,
                           compact: bool = False,
                           mask_dtype: torch.dtype = torch.int32,
                           vote_impl: str = "einsum", parties=None):
    """fn(trees, xb_test[, leaf_idx]) — the one-round forest prediction.

    ``compact=True`` adds the LeafTable's ``leaf_idx`` as a trailing shared
    arg (bit-identical outputs; party sum and vote over live leaves only).
    ``parties`` restricts the protocol to a subset of party indices — the
    distributed substrate's degraded-serving path (the simulated substrate
    always runs every party and ignores it)."""
    from repro_torch.federation import distributed

    def fn(trees, xbt, *shared):
        return prediction.forest_predict_oneround(
            trees, xbt, params, aggregate=True, mask_dtype=mask_dtype,
            vote_impl=vote_impl, leaf_idx=shared[0] if shared else None)
    return substrate.program(
        fn, 2, 1 if compact else 0,
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
    return substrate.program(fn, 2, 2 if compact else 1)


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
    """fn(trees, xb_test) — the multi-round baseline (paper Figs. 4-6)."""
    def fn(trees, xbt):
        return prediction.forest_predict_classical(trees, xbt, params)
    return substrate.program(fn, 2, 0)
