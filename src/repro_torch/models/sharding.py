"""Sharding rules: parameter / optimizer / batch / cache partition specs.

The port's copy of the JAX package's ``models/sharding.py`` (no JAX, no
``repro``).  The rules are the JAX package's, rule for rule: 2-D "FSDP ×
tensor" for every large matrix in ``mode="train"`` (one dim on ``model``,
the other on ``data``, so that the optimizer state shards), tensor/expert
parallel only in ``mode="serve"`` (weights replicated over the data axis);
anything small or non-divisible replicated.  Rules are path-based on the
leaf's name, with divisibility checked against the axis sizes.

Pure functions over shapes.  Where the JAX package takes a device mesh
and returns ``PartitionSpec`` pytrees, these take a dict of axis sizes
(``{"data": 2, "model": 2}``, with ``"pod"`` too for a multi-pod layout)
and return a spec per leaf: a tuple with an axis name (or a tuple of
names) or None per dimension — ``tuple(P(...))`` of JAX's spec, ``()``
where JAX's is ``P()``.  So they run on a model on the ``meta`` device.

Leaves are keyed by the port's parameter names (``blocks.3.attn.wq``).
The JAX package stacks the pattern units on a leading dimension; the port
holds each layer on its own, so the port's spec for a layer's leaf is the
JAX package's without its leading ``None``.  ``models/parallel.py`` lays a
served model out by ``param_specs(mode="serve")``; ``opt_specs`` and train
mode wait for the train half of the sharding port.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Any

import torch

Spec = tuple

# leaf name -> (spec builder) ; d = data axis name, m = model axis name
_MATRIX_RULES = {
    # (in, out) 2D projections: FSDP on in-dim, tensor on out-dim
    "wq": ("d", "m"), "wk": ("d", "m"), "wv": ("d", "m"),
    "wg": ("d", "m"), "wu": ("d", "m"), "w_in": ("d", "m"),
    "in_proj": ("d", "m"), "wi": ("d", "m"), "wf": ("d", "m"),
    # row-parallel outputs
    "wo": ("m", "d"), "wd": ("m", "d"), "out_proj": ("m", "d"),
    # square-ish
    "vision_proj": ("d", "m"),
    "lm_head": ("d", "m"),          # vocab on model => sharded logits/softmax
    "embed": ("m", "d"),            # vocab on model
}


def _axis_ok(dim: int, size: int) -> bool:
    return size > 0 and dim % size == 0


def _spec_for_matrix(shape, rule, axes: dict[str, Any],
                     sizes: dict[str, int]) -> Spec:
    """Apply a 2-trailing-dim rule with divisibility fallback; leading dims
    (the expert dim) get None."""
    lead = [None] * (len(shape) - 2)
    din, dout = shape[-2], shape[-1]
    a_in = (axes[rule[0]] if axes[rule[0]] is not None
            and _axis_ok(din, sizes[rule[0]]) else None)
    a_out = (axes[rule[1]] if axes[rule[1]] is not None
             and _axis_ok(dout, sizes[rule[1]]) else None)
    if a_in is not None and a_in == a_out:
        a_in = None
    return (*lead, a_in, a_out)


def _data_axis(axis_sizes: Mapping[str, int]):
    return ("pod", "data") if "pod" in axis_sizes else "data"


def _axis_size(axis_sizes: Mapping[str, int], axis) -> int:
    if isinstance(axis, tuple):
        out = 1
        for a in axis:
            out *= axis_sizes[a]
        return out
    return axis_sizes[axis]


def _shapes(tree) -> dict[str, tuple[int, ...]]:
    """Leaf name -> shape of a module's parameters or a mapping of
    tensors / shapes."""
    if isinstance(tree, torch.nn.Module):
        return {n: tuple(p.shape) for n, p in tree.named_parameters()}
    return {n: tuple(getattr(v, "shape", v)) for n, v in tree.items()}


def param_specs(params, axis_sizes: Mapping[str, int], mode: str = "train",
                expert_data: bool = False) -> dict[str, Spec]:
    """A spec per parameter of ``params`` (a model, or a mapping of name to
    tensor or shape), by its leaf name.

    mode="train": 2-D FSDP×tensor (optimizer state must shard over data).
    mode="serve": tensor-parallel only — FSDP in-dim sharding makes every
    matmul produce partial sums and all-reduce full activations; at
    serving time there is no optimizer state, so weights replicate over
    the data axes instead.  ``expert_data`` puts the expert stacks' expert
    dim on the data axis (the JAX package's §Perf experiment)."""
    if mode not in ("train", "serve"):
        raise ValueError(f"mode must be 'train' or 'serve', got {mode!r}")
    axes = {"d": _data_axis(axis_sizes) if mode == "train" else None,
            "m": "model"}
    sizes = {"d": _axis_size(axis_sizes, axes["d"]) if mode == "train"
             else 0, "m": _axis_size(axis_sizes, "model")}
    m_sz = sizes["m"]

    def rule(name: str, shape) -> Spec:
        if name in ("we_gate", "we_up", "we_down"):
            # expert-parallel when E | model; else tensor-parallel inside
            # each expert
            e_axis = len(shape) - 3
            lead = [None] * e_axis
            if expert_data:
                if name == "we_down":
                    return (*lead, "data",
                            "model" if _axis_ok(shape[-2], m_sz) else None,
                            None)
                return (*lead, "data", None,
                        "model" if _axis_ok(shape[-1], m_sz) else None)
            if _axis_ok(shape[e_axis], m_sz):
                fs = axes["d"] if _axis_ok(shape[-2], sizes["d"]) else None
                return (*lead, "model", fs, None)
            if name == "we_down":
                return (*lead, None,
                        "model" if _axis_ok(shape[-2], m_sz) else None, None)
            return (*lead, None, None,
                    "model" if _axis_ok(shape[-1], m_sz) else None)
        if name == "r":  # slstm per-head recurrence (4, H, dh, dh)
            return _spec_for_matrix(shape, ("d", "m"), axes, sizes)
        if name == "conv":  # (K, d_inner) depthwise
            return (*[None] * (len(shape) - 1),
                    "model" if _axis_ok(shape[-1], m_sz) else None)
        if name in _MATRIX_RULES and len(shape) >= 2:
            return _spec_for_matrix(shape, _MATRIX_RULES[name], axes, sizes)
        return ()  # norms, gates, router, biases: replicated

    return {n: rule(n.rsplit(".", 1)[-1], shape)
            for n, shape in _shapes(params).items()}


def opt_specs(opt_state, pspecs: dict[str, Spec]) -> dict:
    """mu/nu shard like params; step replicated."""
    return {"mu": pspecs, "nu": pspecs, "step": ()}


def batch_spec(batch_size: int, axis_sizes: Mapping[str, int],
               extra_dims: int = 1) -> Spec:
    """Shard the batch dim over as much of the data(+pod) axes as
    divides."""
    d = _data_axis(axis_sizes)
    if _axis_ok(batch_size, _axis_size(axis_sizes, d)):
        return (d, *[None] * extra_dims)
    if isinstance(d, tuple) and _axis_ok(batch_size, axis_sizes["data"]):
        return ("data", *[None] * extra_dims)
    return (None,) * (extra_dims + 1)


def cache_specs(cache, batch: int, axis_sizes: Mapping[str, int]):
    """KV/SSM cache specs: batch on data axes when divisible; then the first
    remaining dim divisible by the model axis gets 'model'.  ``cache`` is
    the port's (a list with one mapping of tensors per layer); the result
    has its structure, a spec in place of each tensor.

    The port's sharded model holds another layout: each rank's ring holds
    its own kv heads (``models/parallel.py``), where this rule gives
    "model" to the ring's slots when they divide first."""
    d = _data_axis(axis_sizes)
    d_ok = _axis_ok(batch, _axis_size(axis_sizes, d))
    m_sz = _axis_size(axis_sizes, "model")

    def rule(name: str, shape) -> Spec:
        spec = [None] * len(shape)
        if name == "kpos":
            return tuple(spec)
        if len(shape) > 0 and shape[0] == batch and d_ok:
            spec[0] = d
        for i in range(1, len(shape)):
            if shape[i] % m_sz == 0 and shape[i] >= m_sz:
                spec[i] = "model"
                break
        return tuple(spec)

    def walk(tree, name=""):
        if isinstance(tree, Mapping):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [walk(v, name) for v in tree]
        return rule(name, tuple(tree.shape))

    return walk(cache)
