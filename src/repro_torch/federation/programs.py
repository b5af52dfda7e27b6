"""Substrate-specialized forest programs (the fit/predict closures).

  * fit:      party args (xb, feat_gid), shared (feat_sel, weights, y_stats).
  * predict:  the paper's one-round protocol; the result is the shared
    forest output every party computes.

``party0`` normalizes a program output to the master-side host array.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import prediction, tree
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
    fit_fn = functools.partial(tree.build_forest, params=params,
                               hist_impl=hist_impl)
    return substrate.program(fit_fn, 2, 3)


def forest_predict_program(substrate, params: ForestParams, *,
                           compact: bool = False,
                           mask_dtype: torch.dtype = torch.int32,
                           vote_impl: str = "einsum"):
    """fn(trees, xb_test[, leaf_idx]) — the one-round forest prediction.

    ``compact=True`` adds the LeafTable's ``leaf_idx`` as a trailing shared
    arg (bit-identical outputs; party sum and vote over live leaves only)."""
    def fn(trees, xbt, *shared):
        return prediction.forest_predict_oneround(
            trees, xbt, params, aggregate=True, mask_dtype=mask_dtype,
            vote_impl=vote_impl, leaf_idx=shared[0] if shared else None)
    return substrate.program(fn, 2, 1 if compact else 0)
