"""Carry fitted state between the JAX package and the port as NumPy arrays.

Both packages lay a fitted forest out the same way: a PartyTree of seven
arrays with leading (M, T) axes, and a VerticalPartition of host arrays.
These helpers move them across without importing either framework's other
half, so a forest fitted by one package can be served by the other.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Any

import numpy as np
import torch

from repro_torch.core.party import VerticalPartition
from repro_torch.core.tree import PartyTree

_DTYPES = {"is_leaf": np.bool_, "leaf_stats": np.float32,
           "has_split": np.bool_, "split_floc": np.int32,
           "split_bin": np.int32, "owner": np.int32, "split_gid": np.int32}


def party_trees_from_numpy(d: Any, device: torch.device | str) -> PartyTree:
    """A PartyTree on ``device`` from the seven fields of ``d`` — a mapping
    of field name to array, or any object with those attributes (such as
    the JAX package's PartyTree)."""
    get = d.__getitem__ if isinstance(d, Mapping) else (lambda k: getattr(d, k))
    return PartyTree(*(
        torch.as_tensor(np.asarray(get(f)).astype(_DTYPES[f]), device=device)
        for f in PartyTree._fields))


def party_trees_to_numpy(trees: PartyTree) -> dict[str, np.ndarray]:
    """The seven PartyTree fields as host arrays, keyed by field name (the
    JAX package's ``PartyTree(**d)`` takes them as they are)."""
    return {f: getattr(trees, f).detach().cpu().numpy().astype(_DTYPES[f])
            for f in PartyTree._fields}


def partition_from_numpy(xb, feat_gid, n_features: int,
                         boundaries) -> VerticalPartition:
    """The port's VerticalPartition from the JAX package's fields."""
    return VerticalPartition(xb=np.asarray(xb, dtype=np.uint8),
                             feat_gid=np.asarray(feat_gid, dtype=np.int32),
                             n_features=int(n_features),
                             boundaries=np.asarray(boundaries,
                                                   dtype=np.float64))
