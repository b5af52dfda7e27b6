"""Carry fitted state between the JAX package and the port as NumPy arrays.

Both packages lay a fitted forest out the same way: a PartyTree of seven
arrays with leading (M, T) axes, and a VerticalPartition of host arrays.
These helpers move them across without importing either framework's other
half, so a forest fitted by one package can be served by the other.  The
same goes for an LM's weights, both ways (:func:`lm_params_from_numpy`,
:func:`lm_params_to_numpy`), and one way for its decode cache
(:func:`lm_cache_from_numpy`).
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.party import VerticalPartition
from repro_torch.core.tree import PartyTree
from repro_torch.models.transformer import Transformer, layer_kinds

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


def _layer_path(i: int, cfg: ArchConfig) -> tuple[tuple, int | None]:
    """Where layer i lives in the JAX package's parameter or cache pytree:
    (path, unit index along the stacked leading axis, or None).  Layer i is
    pattern position j = i % len(pattern) of unit u = i // len(pattern)
    while the scanned units last, then tail block i - n_units·len(pattern)."""
    n_pat = len(cfg.pattern)
    n_scan = cfg.n_units * n_pat
    if i < n_scan:
        u, j = divmod(i, n_pat)
        return ("units", f"blk{j}"), u
    return ("tail", i - n_scan), None


def _jax_path(name: str, cfg: ArchConfig) -> tuple[tuple, int | None]:
    """Where the port's parameter ``name`` lives in the JAX package's
    pytree: (path of keys and list indices, unit index along the stacked
    leading axis, or None for an unstacked leaf).  A layer's parameters
    are under :func:`_layer_path`; encoder block i's under
    ``enc.units.blk0``, unit i; ``shared_attn`` (one block, not stacked)
    and the model's own leaves (``vision_proj`` too) at the top."""
    parts = name.split(".")
    if parts[0] == "enc_blocks":
        return ("enc", "units", "blk0") + tuple(parts[2:]), int(parts[1])
    if parts[0] != "blocks":
        return tuple(parts), None
    path, u = _layer_path(int(parts[1]), cfg)
    return path + tuple(parts[2:]), u


def _leaves(tree: Any, prefix: tuple = ()):
    """(path, leaf) pairs of nested mappings and lists."""
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (i,))
    else:
        yield prefix, tree


def _get(tree: Any, path: tuple) -> Any:
    for k in path:
        tree = tree[k]
    return tree


def _tree_layers(tree: Mapping) -> int:
    units = [np.shape(v)[0] for _, v in _leaves(tree.get("units", {}))]
    return ((units[0] if units else 0) * len(tree.get("units", {}))
            + len(tree.get("tail", [])))


def lm_param_leaves(tree: Mapping, cfg: ArchConfig,
                    device: torch.device | str | None):
    """The JAX package's LM weights as the port's (parameter name, tensor on
    ``device``) pairs, one leaf at a time, checked as
    :func:`lm_params_from_numpy` checks them (``models/parallel.py``
    keeps a rank's slice of each)."""
    ref = Transformer(cfg, "meta")
    n = _tree_layers(tree)
    if n != cfg.n_layers:
        raise ValueError(f"the tree holds {n} layers, {cfg.name} has "
                         f"{cfg.n_layers}")
    n_enc = _tree_layers(tree.get("enc", {}))
    if n_enc != cfg.enc_layers:
        raise ValueError(f"the tree holds {n_enc} encoder layers, "
                         f"{cfg.name} has {cfg.enc_layers}")
    paths = {name: _jax_path(name, cfg) for name, _ in ref.named_parameters()}
    have = {p for p, _ in _leaves(tree)}
    want = {p for p, _ in paths.values()}
    if have != want:
        raise ValueError(f"keys {sorted(map(str, have - want))} are not the "
                         f"port's; missing {sorted(map(str, want - have))}")
    for name, dst in ref.named_parameters():
        path, u = paths[name]
        leaf = _get(tree, path)
        t = _tensor(leaf if u is None else np.asarray(leaf)[u], device)
        if t.dtype != dst.dtype or t.shape != dst.shape:
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} does "
                             f"not match the port's {dst.dtype} "
                             f"{tuple(dst.shape)}")
        yield name, t


def lm_params_from_numpy(tree: Mapping, cfg: ArchConfig,
                         device: torch.device | str | None) -> Transformer:
    """The port's :class:`Transformer` holding the JAX package's weights.

    ``tree`` is the JAX package's parameter pytree as nested mappings of
    NumPy arrays.  Its scanned units (``tree["units"]["blk{j}"]``, each leaf
    with a leading ``n_units`` axis) are unstacked into layers unit by unit,
    then the ``tail`` blocks follow; an MoE layer's ``ffn`` carries
    ``router``, ``we_gate``, ``we_up``, ``we_down`` and, with shared
    experts, ``shared``; an SSM layer ``ln`` and its ``core``; a use of the
    shared attention block is an empty mapping, the block itself
    ``shared_attn``.  An encoder-decoder's decoder layers carry
    ``ln_cross`` and ``cross``, its encoder ``enc.units.blk0`` stacked over
    ``enc_layers``; a VLM has ``vision_proj``.  Dtypes are kept: a leaf
    whose dtype differs from the port's weight (``ln*`` and ``final_norm``
    float32, matrices and the SSM cores' leaves ``cfg.dtype``) raises, as
    does a shape that differs, a missing or an extra leaf."""
    model = Transformer(cfg, device)
    with torch.no_grad():
        for name, t in lm_param_leaves(tree, cfg, model.device):
            model.get_parameter(name).copy_(t)
    return model


def lm_params_to_numpy(model: Transformer,
                       values: Mapping[str, torch.Tensor] | None = None
                       ) -> dict:
    """The inverse of :func:`lm_params_from_numpy`: the model's weights —
    or ``values``, a tensor per parameter name such as the gradients — as
    the JAX package's nested pytree of NumPy arrays, the layers stacked
    into units over a leading ``n_units`` axis (the encoder's over
    ``enc_layers``), an empty mapping in the
    place of each ``attn_shared`` use (unit or tail), as the JAX package's
    ``init_params`` keeps.  bfloat16 tensors come out as float32 (exact:
    NumPy has no bfloat16 of its own)."""
    cfg = model.cfg
    tree: dict = {}
    stacks: dict[tuple, dict[int, np.ndarray]] = {}
    tail: dict[int, dict] = {}
    for name, p in model.named_parameters():
        t = (p if values is None else values[name]).detach()
        a = (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
        path, u = _jax_path(name, cfg)
        if u is not None:
            stacks.setdefault(path, {})[u] = a
        elif path[0] == "tail":
            _put(tail.setdefault(path[1], {}), path[2:], a)
        else:
            _put(tree, path, a)
    for path, per_unit in stacks.items():
        _put(tree, path, np.stack([per_unit[u]
                                   for u in range(len(per_unit))]))
    if cfg.n_units:
        units = tree.get("units", {})
        tree["units"] = {f"blk{j}": units.get(f"blk{j}", {})
                         for j in range(len(cfg.pattern))}
    if cfg.tail_blocks:
        tree["tail"] = [tail.get(i, {}) for i in range(len(cfg.tail_blocks))]
    return tree


def lm_cache_from_numpy(tree: Mapping, cfg: ArchConfig,
                        device: torch.device | str | None) -> list:
    """The port's decode cache (a list, one entry per layer) from the JAX
    package's (``prefill``'s or ``make_cache``'s): unit leaves unstacked
    layer by layer, then the tail; an attention layer's ``{"self": ring}``
    becomes the ring {k, v, kpos} itself — with cross-attention
    ``{"self": ring, "cross": {k, v}}`` is kept as it is — an SSM layer's
    state is taken as it is.  Dtypes are kept."""
    out = []
    for i, kind in enumerate(layer_kinds(cfg)):
        path, u = _layer_path(i, cfg)
        c = _get(tree, path)
        if kind in ("attn", "attn_shared") and not cfg.cross_attention:
            c = c["self"]
        out.append(_unstack(c, u, device))
    return out


def _unstack(tree: Mapping, u: int | None, device):
    """Nested mappings of arrays as tensors, unit ``u`` of each leaf's
    stacked leading axis (the whole leaf when None)."""
    return {k: _unstack(v, u, device) if isinstance(v, Mapping)
            else _tensor(v if u is None else np.asarray(v)[u], device)
            for k, v in tree.items()}


def _put(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value
