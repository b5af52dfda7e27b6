"""Carry fitted state between the JAX package and the port as NumPy arrays.

Both packages lay a fitted forest out the same way: a PartyTree of seven
arrays with leading (M, T) axes, and a VerticalPartition of host arrays.
These helpers move them across without importing either framework's other
half, so a forest fitted by one package can be served by the other.  The
same goes for a dense LM's weights (:func:`lm_params_from_numpy`).
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.party import VerticalPartition
from repro_torch.core.tree import PartyTree
from repro_torch.models.transformer import Transformer

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


def boosting_rounds_from_numpy(rounds: Any,
                               device: torch.device | str) -> list[PartyTree]:
    """A boosting model's per-round PartyTrees on ``device`` from a
    sequence of rounds, each as :func:`party_trees_from_numpy` takes it
    (such as the JAX package's ``FederatedBoosting.trees_``)."""
    return [party_trees_from_numpy(r, device) for r in rounds]


def party_trees_to_numpy(trees: PartyTree) -> dict[str, np.ndarray]:
    """The seven PartyTree fields as host arrays, keyed by field name (the
    JAX package's ``PartyTree(**d)`` takes them as they are)."""
    return {f: getattr(trees, f).detach().cpu().numpy().astype(_DTYPES[f])
            for f in PartyTree._fields}


def partition_from_numpy(xb, feat_gid, n_features: int, boundaries, *,
                         raw_parts=None,
                         party_names=None) -> VerticalPartition:
    """The port's VerticalPartition from the JAX package's fields, with its
    optional per-party raw blocks and party names."""
    return VerticalPartition(
        xb=np.asarray(xb, dtype=np.uint8),
        feat_gid=np.asarray(feat_gid, dtype=np.int32),
        n_features=int(n_features),
        boundaries=np.asarray(boundaries, dtype=np.float64),
        raw_parts=None if raw_parts is None
        else [np.asarray(r) for r in raw_parts],
        party_names=None if party_names is None else tuple(party_names))


def _tensor(a: Any, device) -> torch.Tensor:
    """A host array as a tensor of the same dtype; bfloat16 arrays (NumPy's
    ``ml_dtypes`` extension type) go through their 16-bit pattern."""
    a = np.array(a)             # a writable host copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def lm_params_from_numpy(tree: Mapping, cfg: ArchConfig,
                         device: torch.device | str | None) -> Transformer:
    """The port's :class:`Transformer` holding the JAX package's weights.

    ``tree`` is the JAX package's parameter pytree as nested mappings of
    NumPy arrays.  Its scanned units (``tree["units"]["blk{j}"]``, each leaf
    with a leading ``n_units`` axis) are unstacked into layers unit by unit,
    then the ``tail`` blocks follow.  Dtypes are kept: a leaf whose dtype
    differs from the port's weight (``ln*`` and ``final_norm`` float32,
    matrices ``cfg.dtype``) raises, as does a shape that differs."""
    model = Transformer(cfg, device)

    def put(dst: torch.Tensor, src: Any, name: str) -> None:
        t = _tensor(src, dst.device)
        if t.dtype != dst.dtype or t.shape != dst.shape:
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} does not "
                             f"match the port's {dst.dtype} "
                             f"{tuple(dst.shape)}")
        dst.copy_(t)

    def fill(blk, p: Mapping, name: str) -> None:
        for key in ("ln1", "ln2"):
            put(getattr(blk, key), p[key], f"{name}.{key}")
        for sub in ("attn", "ffn"):
            mod = getattr(blk, sub)
            want = {n for n, _ in mod.named_parameters()}
            if set(p[sub]) != want:
                raise ValueError(f"{name}.{sub}: keys {sorted(p[sub])} are "
                                 f"not the port's {sorted(want)}")
            for key in want:
                put(getattr(mod, key), p[sub][key], f"{name}.{sub}.{key}")

    with torch.no_grad():
        for key in ("embed", "final_norm", "lm_head"):
            put(getattr(model, key), tree[key], key)
        n_pat = len(cfg.pattern)
        layer = 0
        for u in range(cfg.n_units):
            for j in range(n_pat):
                unit = tree["units"][f"blk{j}"]
                fill(model.blocks[layer],
                     {k: (v[u] if k.startswith("ln") else
                          {kk: vv[u] for kk, vv in v.items()})
                      for k, v in unit.items()}, f"units.blk{j}[{u}]")
                layer += 1
        for i, p in enumerate(tree.get("tail", [])):
            fill(model.blocks[layer], p, f"tail[{i}]")
            layer += 1
    if layer != cfg.n_layers:
        raise ValueError(f"the tree holds {layer} layers, {cfg.name} has "
                         f"{cfg.n_layers}")
    return model
