"""An LM over a ``("data", "model")`` rank mesh: served tensor- and
expert-parallel, laid out by ``models/sharding.py::param_specs(mode=
"serve")``, or trained FSDP × tensor-parallel, laid out by
``param_specs(mode="train")`` and ``opt_specs``.

The JAX package hands these specs to GSPMD, which lowers its prefill and
decode programs onto a device mesh (``launch/cases.py``).  Here the same
layout runs on real ranks, one process each (``launch/mesh.py::RankMesh``,
started as the sharded substrate starts its ranks:
``federation/sharded.py``), and each rank runs the port's own model on its
slices of the weights:

  * column-parallel ``wq wk wv wg wu`` (the out-dim on "model"),
    row-parallel ``wo wd`` (the in-dim), the vocabulary of ``embed`` and
    ``lm_head`` on "model", the MoE's expert stacks on "model" when the
    expert count divides it (else each expert's d_expert); norms, the
    router and every leaf the rules replicate held whole.  Where a dim
    does not divide, the rules replicate it, and so does the model;
  * one all-reduce over the model axis after each row-parallel product
    (``wo``, ``wd``, the MoE's combine) and the vocabulary-sharded
    embedding lookup; the vocabulary-sharded logits all-gathered, so that
    greedy ties break as ``torch.argmax`` breaks them on one device;
  * the MoE: every rank of the model axis holds every token and computes
    the same routing under the whole batch's capacity, runs its own
    experts' slots, and the partial combine is summed
    (``layers.moe``);
  * the batch split over "data" by ``sharding.batch_spec``; each rank's KV
    cache holds its own kv heads (``cache_specs`` would give "model" to
    the ring's slots, and GSPMD reshards: a layout of the JAX package's
    own, not this one);
  * ``expert_data`` (``param_specs(..., expert_data=True)``, in both
    modes): the expert stacks' expert dim on "data" — rank (i, j) holds
    experts [i·E_loc, (i+1)·E_loc), padded with dead experts where the
    data axis does not divide them, as GSPMD pads — and d_expert on
    "model" where it divides; the rank runs its experts over the whole
    batch's tokens and returns each data shard its rows (``layers.moe``).

Training (``mode="train"``, the JAX package's ``launch/cases.py`` train
case: ``make_train_step`` under ``param_specs(mode="train")``,
``opt_specs`` and ``batch_spec``) holds every large matrix sharded on
both axes: one dim on "model" as above, the other on "data" (FSDP), so
that AdamW's moments shard with it:

  * the autograd-aware collectives of ``models/collectives.py``:
    ``copy_to_model`` at the input of every column-parallel region,
    ``reduce_from_model`` after every row-parallel product and the
    vocabulary-sharded lookup, ``gather_last`` on the training logits,
    and an FSDP product (``collectives.matmul``) for every leaf sharded
    over "data": its shards all-gathered for the product and freed, the
    weight's gradient reduce-scattered over "data" in the backward;
  * a rank runs the port's own ``train/step.py::make_train_step`` on its
    rows of each microbatch (``sharding.batch_spec`` of a microbatch,
    the JAX package's order: microbatch i is rows [i·mb, (i+1)·mb) of the
    global batch, split over "data"); its model's :class:`TrainLayout`
    then sums over "model" the gradient of each leaf held whole but used
    on the rank's share of a region (the MoE's router through its own
    experts' gates, ``q_norm`` / ``k_norm`` on its own heads), averages
    over "data" the gradient of every leaf held whole there, and the
    loss and CE over "data" (each rank's CE is its rows' mean);
  * AdamW is elementwise, so a rank's μ, ν and parameters are the slices
    of the unsharded ones (``opt_specs``: μ and ν as the parameters,
    ``step`` replicated);
  * the MoE's aux loss is the whole batch's (``layers.moe``).

Attention is split on head boundaries (:func:`head_run`): model rank j
of m holds the run of whole q heads [⌊j·H/m⌋, ⌊(j+1)·H/m⌋) — the even
split [j·H/m, (j+1)·H/m) where m divides H; runs that differ by at most
one head where it does not (whisper's 20 heads at m = 8); none on some
ranks where m > H — and every kv head its q heads read
(:func:`kv_run`, q head h reading kv head h // G as on one device), so a
run that straddles two kv heads' groups holds both (qwen2-vl's 2 kv heads
at m = 8), and a kv head whose group spans several runs (glm4-9b's 2 at
m = 4) is replicated on their ranks.  JAX's spec cuts the projections'
columns evenly whenever the width divides, and GSPMD reshards heads that
straddle ranks: the specs stay JAX's, the layout is this one.  The
existing all-reduce after ``wo`` sums the ranks' outputs; in training the
partial gradients of a kv head held by several ranks are summed over
them only (:class:`TrainLayout`).  Nothing pads a head.  A layout raises
NotImplementedError only where JAX's spec splits some of a block's
projections over "model" and not the others (a width that does not
divide: :func:`serve_specs`, :func:`train_specs`).

The recurrent families (Mamba2, mLSTM, sLSTM; zamba2's shared attention
block takes the decoder-only rules) keep JAX's specs too, and the rank
layout is again the port's own (:func:`_ssm_heads`): JAX's contiguous
split of ``in_proj`` and ``w_in`` would cut across their segments
(Mamba2's [z | x | B | C | dt], mLSTM's [xi | z], sLSTM's four gates) and
of sLSTM's ``r`` across dh, and GSPMD would reshard.  So rank j holds the
heads :func:`head_run` gives it of every per-head quantity — its columns of each
segment, of ``wq wk wi wf``, its rows of ``out_proj``, its channels of
``conv`` and ``out_norm``, its heads of ``a_log dt_bias d_skip`` and of
``r`` (whose dim 2 stays on "data" in training, as JAX's) — and whole
each input that every head reads: Mamba2's B and C columns, mLSTM's
``xi`` columns.  A leaf whose rank part is several column runs is indexed
by an array on that dim.  The forward needs one new collective, the
``out_norm`` statistic summed over "model" both ways
(``collectives.all_sum``, over the config's whole d_inner); in training
the gradients of the columns held whole are summed over "model" in the
packed all-reduce (:class:`TrainLayout`), and the per-head leaves are the
rank's own.

The encoder-decoder (whisper) and the VLM (qwen2-vl) run under the same
rules: each encoder block and each decoder block's cross-attention is
laid out as a decoder block's attention and MLP are (the cross cache
{k, v} holds the rank's own kv heads of its own rows), the encoder's
frames are held whole over "model" and split by rows over "data", and
``vision_proj``'s columns are split over "model" and gathered after the
product (``collectives.gather_last``).  A batch's modality stubs, the
``extras`` (``frames``, ``patches``), reach every rank beside its tokens,
and each rank takes its rows of them.

The weights equal the unsharded model's: a rank draws every full leaf in
``transformer.init_params``'s order (``transformer.draw_params``) from
the same seed on its own device, keeps its slice, and frees the rest
before the next leaf; or it slices the JAX package's weights
(``convert.lm_param_leaves``).  At a model axis of 1 every collective is
the identity and the sharded model computes the unsharded model's bits.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import DATA_AXIS, MODEL_AXIS, RankMesh
from repro_torch.models import collectives, layers, sharding, ssm, transformer

# each attention projection's dim that its heads split
_ATTN_LEAVES = {"wq": 1, "wk": 1, "wv": 1, "wo": 0}
_KV_LEAVES = ("wk", "wv")
_EXPERT_STACKS = ("we_gate", "we_up", "we_down")


def _sizes(mesh: RankMesh) -> dict[str, int]:
    """The data and model axes' sizes (a "pod" axis folded into "data",
    as JAX's ``_data_axis`` folds it)."""
    return {DATA_AXIS: mesh.axis_size(DATA_AXIS),
            MODEL_AXIS: mesh.axis_size(MODEL_AXIS)}


def serve_specs(cfg: ArchConfig, axis_sizes,
                expert_data: bool = False) -> dict[str, tuple]:
    """``sharding.param_specs(mode="serve", expert_data=...)`` of ``cfg``'s
    parameters at ``axis_sizes``, after checking that the sharded forward
    runs that layout: NotImplementedError names the config and the leaf
    otherwise."""
    return _checked_specs(cfg, axis_sizes, "serve", expert_data)


def train_specs(cfg: ArchConfig, axis_sizes,
                expert_data: bool = False) -> dict[str, tuple]:
    """``sharding.param_specs(mode="train", expert_data=...)`` of ``cfg``'s
    parameters at ``axis_sizes`` after :func:`serve_specs`'s checks: the
    model axis splits the same dims; the data axis the other dim of each
    matrix (the expert dim of the expert stacks under ``expert_data``)."""
    return _checked_specs(cfg, axis_sizes, "train", expert_data)


SPECS = {"serve": serve_specs, "train": train_specs}


def head_run(n: int, j: int, m: int) -> tuple[int, int]:
    """[lo, hi): the run of whole heads of ``n`` that model rank ``j`` of
    ``m`` holds, ⌊j·n/m⌋ to ⌊(j+1)·n/m⌋ — [j·n/m, (j+1)·n/m) where m
    divides n; at most ⌈n/m⌉ heads, and none on some ranks where m > n."""
    return j * n // m, (j + 1) * n // m


def kv_run(cfg: ArchConfig, j: int, m: int) -> tuple[int, int]:
    """[lo, hi): the kv heads that model rank ``j`` of ``m`` holds — every
    kv head that its q heads (:func:`head_run`) read, q head h reading kv
    head h // (H / kv); none for a rank without q heads."""
    lo, hi = head_run(cfg.n_heads, j, m)
    g = cfg.n_heads // cfg.n_kv_heads
    return (lo // g, lo // g) if hi == lo else (lo // g, (hi - 1) // g + 1)


def kv_replicas(cfg: ArchConfig, model: int) -> int:
    """The most model ranks that share one kv head at a model axis of
    ``model`` (:func:`kv_run`; 1 where each kv head is on one rank)."""
    held = [0] * cfg.n_kv_heads
    for j in range(model):
        for h in range(*kv_run(cfg, j, model)):
            held[h] += 1
    return max(held)


def _cores(cfg: ArchConfig) -> dict[str, str]:
    """The prefix of each recurrent core ("blocks.3.core") -> its kind."""
    return {f"blocks.{i}.core": kind
            for i, kind in enumerate(transformer.layer_kinds(cfg))
            if kind in ssm.CORES}


def _checked_specs(cfg: ArchConfig, axis_sizes, mode: str,
                   expert_data: bool = False):
    meta = transformer.Transformer(cfg, "meta")
    specs = sharding.param_specs(meta, axis_sizes, mode=mode,
                                 expert_data=expert_data)
    m = axis_sizes[MODEL_AXIS]
    for prefix, mod in meta.named_modules():
        if isinstance(mod, layers.Attention):
            on = {leaf: specs[f"{prefix}.{leaf}"][dim] == MODEL_AXIS
                  for leaf, dim in _ATTN_LEAVES.items()}
            off = [leaf for leaf, split in on.items() if not split]
            if off and len(off) < len(on):
                p = mod.get_parameter(off[0])
                raise NotImplementedError(
                    f"{cfg.name}: {prefix}.{off[0]} at model = {m} does "
                    f"not split (its {p.shape[_ATTN_LEAVES[off[0]]]} "
                    f"columns of {cfg.n_heads} q heads on "
                    f"{cfg.n_kv_heads} kv heads of {cfg.head_dim}), while "
                    f"the block's other projections do")
        elif isinstance(mod, layers.MLP):
            on = [MODEL_AXIS in specs[f"{prefix}.{leaf}"]
                  for leaf in ("wg", "wu", "wd")]
            if len(set(on)) > 1:
                raise NotImplementedError(
                    f"{cfg.name}: {prefix} is split in part at model = {m}")
    return specs


def _slices(name: str, spec: tuple, shape, at: dict) -> tuple:
    """The part of leaf ``name`` of ``shape`` that a rank holds under
    ``spec``: ``at`` maps each axis to the rank's (index, size) along it.
    An axis must divide the dim it splits, but for an expert stack's
    expert dim: there the slices pass the leaf's end, over dead experts."""
    out = []
    for dim, n in enumerate(shape):
        axis = spec[dim] if dim < len(spec) else None
        if axis in at:
            index, size = at[axis]
            k, left = divmod(n, size)
            if left:
                if dim or name.rpartition(".")[2] not in _EXPERT_STACKS:
                    raise ValueError(f"{name}: dim {dim} of {tuple(shape)} "
                                     f"does not split over {size} ranks of "
                                     f"{axis!r}")
                k += 1
            out.append(slice(index * k, (index + 1) * k))
        else:
            out.append(slice(None))
    return tuple(out)


def _ssm_heads(cfg: ArchConfig, kind: str, leaf: str, j: int, m: int):
    """(dim, index) of the share of leaf ``leaf`` of a ``kind`` core that
    model rank j of m holds: its heads (:func:`head_run`) of every
    per-head quantity, as a slice, or as an index array where its share is
    a run of columns in each segment of the leaf, with the columns that
    every head reads whole (Mamba2's B and C, mLSTM's ``xi``); None for a
    leaf held whole (sLSTM's ``in_norm``)."""
    hh, di, n = cfg.n_ssm_heads, cfg.d_inner, cfg.ssm_state
    h0, h1 = head_run(hh, j, m)
    d0, d1 = h0 * (di // hh), h1 * (di // hh)

    def run(lo: int) -> np.ndarray:
        return np.arange(lo + d0, lo + d1)
    own, heads = slice(d0, d1), slice(h0, h1)
    rows = {"out_norm": (0, own), "out_proj": (0, own)}
    if kind == "mamba2":          # in_proj: [z | x | B | C | dt]
        cols = np.concatenate([run(0), run(di),
                               np.arange(2 * di, 2 * di + 2 * n),
                               np.arange(2 * di + 2 * n + h0,
                                         2 * di + 2 * n + h1)])
        return {"in_proj": (1, cols), "conv": (1, own), "a_log": (0, heads),
                "dt_bias": (0, heads), "d_skip": (0, heads),
                **rows}.get(leaf)
    if kind == "mlstm":           # in_proj: [xi | z]
        cols = np.concatenate([np.arange(di), run(di)])
        qk = slice(h0 * n, h1 * n)
        return {"in_proj": (1, cols), "wq": (1, qk), "wk": (1, qk),
                "wi": (1, heads), "wf": (1, heads), **rows}.get(leaf)
    cols = np.concatenate([run(g * di) for g in range(4)])  # i f z o
    return {"w_in": (1, cols), "r": (1, heads), **rows}.get(leaf)


def _attn_heads(cfg: ArchConfig, j: int, m: int) -> dict:
    """Attention leaf -> (dim, slice) of model rank j of m's heads: its q
    heads' columns of ``wq`` and rows of ``wo`` (:func:`head_run`), its kv
    heads' columns of ``wk`` and ``wv`` (:func:`kv_run`)."""
    dh = cfg.head_dim
    q0, q1 = head_run(cfg.n_heads, j, m)
    k0, k1 = kv_run(cfg, j, m)
    q, kv = slice(q0 * dh, q1 * dh), slice(k0 * dh, k1 * dh)
    return {"wq": (1, q), "wk": (1, kv), "wv": (1, kv), "wo": (0, q)}


def _layout(cfg: ArchConfig, specs: dict, at: dict) -> dict[str, tuple]:
    """Parameter name -> the rank's :func:`_slices` of the leaf; an
    attention projection that JAX's spec splits over "model", and a
    recurrent core's leaf at a model axis past 1, by the rank's heads
    (:func:`_attn_heads`, :func:`_ssm_heads`), their data axis's split
    JAX's."""
    index, size = at[MODEL_AXIS]
    cores = _cores(cfg) if size > 1 else {}
    attn = _attn_heads(cfg, index, size)
    meta = transformer.Transformer(cfg, "meta")
    attns = {prefix for prefix, mod in meta.named_modules()
             if isinstance(mod, layers.Attention)}
    out = {}
    for name, p in meta.named_parameters():
        owner, _, leaf = name.rpartition(".")
        if owner in cores:
            head = _ssm_heads(cfg, cores[owner], leaf, index, size)
        elif owner in attns and leaf in attn and MODEL_AXIS in specs[name]:
            head = attn[leaf]
        else:
            out[name] = _slices(name, specs[name], p.shape, at)
            continue
        spec = tuple(None if a == MODEL_AXIS else a for a in specs[name])
        parts = list(_slices(name, spec, p.shape, at))
        if head is not None:
            parts[head[0]] = head[1]
        out[name] = tuple(parts)
    return out


def _clamped(index: tuple, shape) -> tuple:
    """``index`` cut at the leaf's end (what is left of padded slices)."""
    return tuple(s if not isinstance(s, slice) or s.start is None else
                 slice(min(s.start, n), min(s.stop, n))
                 for s, n in zip(index, shape))


def rank_slices(cfg: ArchConfig, mesh: RankMesh, rank: int,
                mode: str = "train",
                expert_data: bool = False) -> dict[str, tuple]:
    """Parameter name -> the index (a tuple of slices, and of an index
    array on the dim where a recurrent core's share is several column
    runs) of the part of the whole leaf that rank ``rank`` of ``mesh``
    holds in ``mode`` (its live part: a rank's dead experts are in no
    leaf)."""
    specs = SPECS[mode](cfg, _sizes(mesh), expert_data)
    shapes = dict(transformer.Transformer(cfg, "meta").named_parameters())
    return {name: _clamped(index, shapes[name].shape) for name, index in
            _layout(cfg, specs, _coords(mesh, rank)).items()}


def _coords(mesh: RankMesh, rank: int) -> dict:
    """Each axis -> (``rank``'s index along it, the axis's size)."""
    return {ax: (mesh.axis_index(rank, ax), mesh.axis_size(ax))
            for ax in (DATA_AXIS, MODEL_AXIS)}


def _extent(index: tuple, shape) -> list[int]:
    return [len(s) if not isinstance(s, slice) else
            s.stop - s.start if s.start is not None else n
            for s, n in zip(index, shape)]


def _local_model(cfg: ArchConfig, layout: dict,
                 device) -> transformer.Transformer:
    """A model whose every parameter has the shape of its slice in
    ``layout``, on ``device``, uninitialised; ``model.live`` maps each
    leaf padded with dead experts to the number of live ones."""
    model = transformer.Transformer(cfg, "meta")
    model.live = {}
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        shape = _extent(layout[name], p.shape)
        live = _extent(_clamped(layout[name], p.shape), p.shape)
        if live != shape:
            model.live[name] = live[0]
        setattr(model.get_submodule(owner), leaf,
                layers.empty_param(shape, p.dtype, device))
    return model


def _take(value: torch.Tensor, index: tuple) -> torch.Tensor:
    """``value[index]``, zero-filled where ``index`` passes its end (the
    dead experts: zero weights that no token is routed to)."""
    part = value[index]
    shape = _extent(index, value.shape)
    if list(part.shape) == shape:
        return part
    out = part.new_zeros(shape)
    out[tuple(slice(0, n) for n in part.shape)] = part
    return out


def live_leaves(model: transformer.Transformer, tensors: dict) -> dict:
    """``tensors`` (a value per parameter name of a rank's ``model``) cut
    to the live experts of each padded leaf: the part of the whole leaf
    that :func:`rank_slices` places."""
    live = model.live
    return {n: t[:live[n]] if n in live else t for n, t in tensors.items()}


def shard_model(cfg: ArchConfig, mesh: RankMesh, rank: int, *, seed: int = 0,
                params=None, comm=None, mode: str = "serve",
                expert_data: bool = False,
                draw: bool = True) -> transformer.Transformer:
    """Rank ``rank``'s share of ``cfg``'s model on ``mesh``: its slices of
    the weights by :func:`serve_specs` (``mode="serve"``) or
    :func:`train_specs` (``mode="train"``), with the expert stacks split
    over "data" under ``expert_data``, on its device, its modules bound to
    ``comm`` (the rank's ``federation/sharded.py::DistComm`` over its
    model axis, the data axis's under ``comm.axes["data"]``).

    The weights are ``transformer.init_params(cfg, seed)``'s, drawn leaf
    by leaf on the rank's device, or the JAX package's pytree ``params``
    (``convert.lm_param_leaves``); with ``draw=False`` they are left
    unset (the dry run's fake tensors: ``launch/cases.py``).  Without
    ``comm`` the model axis (and to train, the data axis) must be 1 and
    the model runs alone."""
    from repro_torch import convert
    if mode not in SPECS:
        raise ValueError(f"mode must be one of {tuple(SPECS)}, got {mode!r}")
    sizes = _sizes(mesh)
    split = (MODEL_AXIS,) + ((DATA_AXIS,) if mode == "train" or expert_data
                             else ())
    if comm is None and any(sizes[ax] > 1 for ax in split):
        raise ValueError(f"a mesh of {sizes} needs the rank's comm to "
                         f"{mode}")
    specs = SPECS[mode](cfg, sizes, expert_data)
    at = _coords(mesh, rank)
    layout = _layout(cfg, specs, at)
    dev = torch.device(mesh.devices[rank])
    model = _local_model(cfg, layout, dev)
    if not draw:
        leaves = ()
    elif params is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        leaves = transformer.draw_params(cfg, gen, dev)
    else:
        leaves = convert.lm_param_leaves(params, cfg, dev)
    with torch.no_grad():
        for name, value in leaves:
            model.get_parameter(name).copy_(_take(value, layout[name]))
            del value
    if comm is not None:
        _bind(model, specs, comm, at)
        if mode == "train":
            _bind_train(model, specs, comm, at)
    return model


def _bind(model: transformer.Transformer, specs: dict, comm,
          at: dict) -> None:
    """Give each module whose weights are sharded the model axis's comm
    (and an MoE its first expert and, with its experts split over "data",
    that axis's comm, a sharded attention or recurrent core the first of
    its heads); every recurrent core holds its heads."""
    model.tp = comm
    cfg, (index, size) = model.cfg, at[MODEL_AXIS]
    for prefix, mod in model.named_modules():
        if isinstance(mod, ssm._Core):
            mod.tp = comm
            mod.head_first = head_run(cfg.n_ssm_heads, index, size)[0]
        elif isinstance(mod, (layers.Attention, layers.MLP)):
            row = "wo" if isinstance(mod, layers.Attention) else "wd"
            if MODEL_AXIS in specs[f"{prefix}.{row}"]:
                mod.tp = comm
                if row == "wo":
                    mod.q_first = head_run(cfg.n_heads, index, size)[0]
        elif isinstance(mod, layers.MoE):
            spec = specs[f"{prefix}.we_down"]
            axis = spec[0] if spec else None     # the expert dim's
            if axis in at:
                mod.expert_offset = at[axis][0] * mod.we_down.shape[0]
            if axis == DATA_AXIS and at[DATA_AXIS][1] > 1:
                mod.experts = comm.axes[DATA_AXIS]
            if MODEL_AXIS in spec:
                mod.tp = comm


def _bind_train(model: transformer.Transformer, specs: dict, comm,
                at: dict) -> None:
    """Give each module its leaves sharded over the data axis (``fsdp``)
    and the model its :class:`TrainLayout`.  An expert stack split over
    "data" by its expert dim is no FSDP leaf: its rank's experts are its
    own.  The columns of a recurrent core's ``in_proj`` that every model
    rank holds whole (Mamba2's B and C, mLSTM's ``xi``) take each rank's
    part of their gradient, summed over "model"."""
    data = comm.axes.get(DATA_AXIS)
    if data is not None and data.n_parties == 1:
        data = None
    experts = [name for name, spec in specs.items()
               if name.rpartition(".")[2] in _EXPERT_STACKS
               and spec[:1] == (DATA_AXIS,)]
    summed, cols = [], {}
    for prefix, mod in model.named_modules():
        pre = f"{prefix}." if prefix else ""
        dims = {leaf: specs[pre + leaf].index(DATA_AXIS)
                for leaf, _ in mod.named_parameters(recurse=False)
                if DATA_AXIS in specs[pre + leaf]
                and pre + leaf not in experts}
        if dims and data is not None:
            mod.fsdp = collectives.FSDP(data, dims)
        if getattr(mod, "tp", None) is not None:
            if isinstance(mod, layers.MoE):
                summed.append(pre + "router")
            elif isinstance(mod, layers.Attention):
                summed += [pre + leaf for leaf in ("q_norm", "k_norm")
                           if hasattr(mod, leaf)]
            elif isinstance(mod, ssm.Mamba2):      # [z | x | B | C | dt]
                di, n = mod.conv.shape[1], model.cfg.ssm_state
                cols[pre + "in_proj"] = (2 * di, 2 * di + 2 * n)
            elif isinstance(mod, ssm.MLSTM):       # [xi | z]
                cols[pre + "in_proj"] = (0, model.cfg.d_inner)
    whole = ([name for name, spec in specs.items() if DATA_AXIS not in spec]
             if data is not None else [])
    cfg, (index, size) = model.cfg, at[MODEL_AXIS]
    cores = _cores(cfg)               # mLSTM's wk is no kv head
    run = (*kv_run(cfg, index, size), cfg.n_kv_heads, cfg.head_dim)
    shared = ({name: run for name, spec in specs.items()
               if name.rpartition(".")[2] in _KV_LEAVES
               and name.rpartition(".")[0] not in cores
               and MODEL_AXIS in spec}
              if kv_replicas(cfg, size) > 1 else {})
    model.layout = TrainLayout(data, comm if comm.n_parties > 1 else None,
                               whole, summed, experts if data else (),
                               shared, cols)


class TrainLayout:
    """The reductions a training step makes on a rank of a sharded model
    (``train/step.py::make_train_step`` calls them): ``data`` and
    ``model`` are the axes' comms (None for an axis of one); the
    gradients of the leaves ``model_sum`` are summed over "model" — each
    rank computed them from its share of a region — and those of the
    leaves ``data_mean``, held whole over "data", averaged over it (the
    FSDP leaves' were reduce-scattered in the backward pass).  One
    all-reduce for each axis, of the leaves' float32 gradients packed
    together.

    ``kv_shared`` maps each ``wk`` / ``wv`` leaf, where some kv head is
    held by several model ranks (:func:`kv_replicas`), to (lo, hi, n, w):
    the rank holds kv heads [lo, hi) of n, each w columns.  Each rank
    holds the part of its heads' gradient from its own q heads, which goes
    into the model axis's all-reduce in its heads' slots of zeros, so that
    the sum over a head's slot is over the ranks that hold it and every
    one of them receives the same bits.  ``experts`` are the
    expert stacks split over "data" (``expert_data``): the backward of the
    MoE's row scatter gave a rank's experts the gradient of every data
    shard's loss, so, with the batch's rows split over "data" (``rows``,
    set by :func:`_split_batch`), it is divided by the axis's size — the
    mean over the axis that the loss takes — without a collective.
    ``model_cols`` maps a leaf to the run [lo, hi) of its last dim whose
    gradient is summed over "model" in the same all-reduce (a recurrent
    core's columns that every model rank holds whole); the rest of the
    leaf is the rank's own."""

    rows = None                    # the data axis's comm when it splits rows

    def __init__(self, data, model, data_mean, model_sum, experts=(),
                 kv_shared=None, model_cols=None):
        self.data, self.model = data, model
        self.data_mean = frozenset(data_mean)
        self.model_sum = frozenset(model_sum) if model is not None else ()
        self.kv_shared = dict(kv_shared or {}) if model is not None else {}
        self.model_cols = dict(model_cols or {}) if model is not None else {}
        self.experts = frozenset(experts)

    def sync_grads(self, names, grads) -> list:
        grads = list(grads)
        if self.model is not None:
            at = [i for i, n in enumerate(names)
                  if n in self.model_sum or n in self.kv_shared
                  or n in self.model_cols]
            slots = [self.kv_shared.get(names[i]) for i in at]
            _packed_sum(self.model, grads, at, slots,
                        cols=[self.model_cols.get(names[i]) for i in at])
        if self.data is not None:
            at = [i for i, n in enumerate(names) if n in self.data_mean]
            _packed_sum(self.data, grads, at, [None] * len(at),
                        self.data.n_parties)
        if self.rows is not None and self.experts:
            for i, n in enumerate(names):
                if n in self.experts:       # in place: no float32 copy
                    grads[i].div_(self.rows.n_parties)
        return grads

    def data_average(self, *values: torch.Tensor) -> list:
        """Scalars averaged over the data axis (each rank's loss and CE
        are its rows' means)."""
        if self.data is None:
            return list(values)
        out = self.data.all_reduce(torch.stack(
            [v.float() for v in values])).div_(self.data.n_parties)
        return list(out.unbind())


def _packed_sum(comm, grads: list, at: list, slots: list,
                scale: int = 1, cols: Optional[list] = None) -> None:
    """Sum the float32 gradients ``grads[i]`` for ``i`` in ``at`` over
    ``comm`` in one all-reduce, then divided by ``scale``; in place in
    ``grads``.  Where ``slots`` gives (lo, hi, n, w) for an entry, its
    last dim holds heads [lo, hi) of n, each w wide, and each head goes
    into its own block of n blocks of zeros (head-major), so that a head's
    sum is over the ranks that hold it.  Where ``cols`` gives (lo, hi) for
    an entry, only that run of the last dim is summed, and the gradient
    becomes float32 with the sum in those columns."""
    if not at:
        return
    cols = cols or [None] * len(at)
    parts = []
    for i, slot, c in zip(at, slots, cols):
        g = grads[i].float()
        g = g if c is None else g[..., c[0]:c[1]]
        if slot is not None:
            lo, hi, n, w = slot
            rows = math.prod(g.shape[:-1])
            blocks = g.new_zeros((n, rows, w))
            blocks[lo:hi] = g.reshape(rows, hi - lo, w).transpose(0, 1)
            g = blocks
        parts.append(g.reshape(-1))
    flat = comm.all_reduce(torch.cat(parts))
    if scale != 1:
        flat = flat.div_(scale)
    off = 0
    for i, slot, c, part in zip(at, slots, cols, parts):
        k = part.numel()
        got = flat[off:off + k]
        off += k
        if slot is not None:
            lo, hi, n, w = slot
            shape = grads[i].shape
            got = got.view(n, -1, w)[lo:hi].transpose(0, 1).reshape(shape)
            grads[i] = got
        elif c is None:
            grads[i] = got.view(grads[i].shape)
        else:
            g = grads[i].float()
            part = g[..., c[0]:c[1]]
            part.copy_(got.view(part.shape))
            grads[i] = g


def _split_batch(model: transformer.Transformer, data) -> None:
    """Route the MoE layers over the whole batch when ``data`` (the data
    axis's comm) splits it, over this rank's rows otherwise."""
    for mod in model.modules():
        if isinstance(mod, layers.MoE):
            mod.data = data
    if model.layout is not None:
        model.layout.rows = data


# ------------------------------------------------------------- the rank side
def _cfg_from_wire(d: dict) -> ArchConfig:
    d = dict(d)
    d["pattern"] = tuple(d["pattern"])
    if d.get("mrope_sections") is not None:
        d["mrope_sections"] = tuple(d["mrope_sections"])
    return ArchConfig(**d)


def _rows(comm, batch: int):
    """This rank's rows of a batch of ``batch`` (``sharding.batch_spec``)
    and the data axis's comm when the batch is split over it, else
    None."""
    data = comm.axes.get(DATA_AXIS)
    sizes = {DATA_AXIS: data.n_parties if data else 1,
             MODEL_AXIS: comm.n_parties}
    if data is None or sharding.batch_spec(batch, sizes)[0] != DATA_AXIS:
        return slice(None), None
    k = batch // data.n_parties
    return slice(data.party_index * k, (data.party_index + 1) * k), data


def _gather_rows(t: torch.Tensor, data) -> np.ndarray:
    """Every data rank's rows of ``t`` on the host (bf16 as float32, which
    NumPy holds exactly)."""
    t = t if data is None else data.all_gather_cat(t, 0)
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _align(dev: torch.device) -> None:
    """Wait until every rank of the world holds its input: the session
    sends the ranks their batch one after another (a wave's stubs are
    tens of MB a rank), so without this the first collective of a timed
    region would count a rank's wait for its peers' input."""
    import torch.distributed as dist
    if dist.get_world_size() > 1:
        dist.barrier(**({"device_ids": [dev.index]}
                        if dist.get_backend() == "nccl" else {}))


def _train_rows(comm, batch: int, micro_batch: int):
    """This rank's rows of a training batch of ``batch``, microbatch by
    microbatch (``micro_batch`` rows each, 0 for one): its rows of
    microbatch i, rows [i·mb, (i+1)·mb) of the batch, by
    ``sharding.batch_spec`` of a microbatch; the rank's microbatch size
    (0 for one microbatch) and the data axis's comm when the microbatches
    are split over it, else None."""
    mb = micro_batch or batch
    if batch % mb:
        raise ValueError(f"batch {batch} is no multiple of micro_batch {mb}")
    rows, data = _rows(comm, mb)
    idx = np.arange(batch).reshape(batch // mb, mb)[:, rows].reshape(-1)
    return idx, (len(idx) * mb // batch if micro_batch else 0), data


def _host(tensors: dict) -> dict:
    return {n: t.detach().float().cpu().numpy() for n, t in tensors.items()}


def _host_cache(c):
    """A layer's cache on the host: its tensors as arrays, nested as it is
    nested (a cross-attention layer's {"self": ring, "cross": {k, v}})."""
    if isinstance(c, dict):
        return {k: _host_cache(v) for k, v in c.items()}
    return c.cpu().numpy()


def _extras(extras: Optional[dict], rows, dev) -> dict:
    """This rank's ``rows`` of each modality stub (``frames``,
    ``patches``: host arrays of the whole batch) as tensors on ``dev``."""
    return {k: torch.as_tensor(np.asarray(v)[rows], device=dev)
            for k, v in (extras or {}).items()}


_KINDS = (("AllGather", "all_gather"), ("ReduceScatter", "reduce_scatter"),
          ("AllReduce", "all_reduce"))


def _device_ms(prof) -> dict:
    """A profiled step's device milliseconds by kind: each NCCL
    collective's kernels, and every other kernel or copy (compute).  Only
    the device's own events count: a host operator's self device time is
    its kernels' again."""
    from torch.autograd import DeviceType
    out = {kind: 0.0 for _, kind in _KINDS}
    out["compute"] = 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CPU:
            continue
        ms = e.self_device_time_total / 1e3
        kind = next((k for tag, k in _KINDS if tag in e.key), "compute")
        out[kind] += ms
    return out


def _train(comm, payload: dict, tokens: np.ndarray,
           extras: Optional[dict] = None) -> dict:
    """``train`` (one ``make_train_step`` step on this rank's rows of
    ``tokens`` and of the modality stubs ``extras``) or ``grads`` (the
    step's reduced gradients, no update): the whole batch's
    loss, CE and aux, the rank's step seconds and peak device bytes, the
    peak bytes of FSDP-gathered weights alive and the names of the leaves
    gathered (``collectives.GATHERED``);
    with ``return_state`` the rank's parameter and AdamW slices; with
    ``profile`` the step's device milliseconds by kind (:func:`_device_ms`,
    under ``torch.profiler``)."""
    import contextlib

    from repro_torch.train import step
    held, dev = comm.held, comm.device
    model, mb = held["model"], held["micro_batch"]
    rows, local_mb, data = _train_rows(comm, tokens.shape[0], mb)
    _split_batch(model, data)
    batch = {"tokens": torch.as_tensor(tokens[rows], dtype=torch.int64,
                                       device=dev),
             **_extras(extras, rows, dev)}
    _align(dev)
    collectives.GATHERED.reset()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    prof = None
    if payload.get("profile"):
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU]
                       + ([ProfilerActivity.CUDA] if dev.type == "cuda"
                          else []))
    _sync(dev)
    t0 = time.perf_counter()
    with prof if prof is not None else contextlib.nullcontext():
        if payload["op"] == "train":
            fn = step.make_train_step(held["cfg"], micro_batch=local_mb,
                                      lr=held["lr"])
            _, held["opt"], metrics = fn(model, held["opt"], batch)
            grads = None
        else:
            names, grads, metrics = step.accumulate_grads(model, batch,
                                                          local_mb)
        _sync(dev)
    out = {k: float(v) for k, v in metrics.items()}
    if prof is not None:
        out["device_ms"] = _device_ms(prof)
    out.update(step_s=time.perf_counter() - t0,
               peak_bytes=(torch.cuda.max_memory_allocated(dev)
                           if dev.type == "cuda" else 0),
               gathered_peak_bytes=collectives.GATHERED.peak,
               gathered_leaves=sorted(collectives.GATHERED.names))
    if grads is not None:
        stride = int(payload.get("stride", 1))
        out["grads"] = _host({
            n: g if stride == 1 else g.reshape(-1)[::stride]
            for n, g in live_leaves(model, dict(zip(names, grads))).items()})
    if payload.get("return_state"):
        out["params"], out["mu"], out["nu"] = (
            _host(live_leaves(model, t)) for t in (
                dict(model.named_parameters()), held["opt"]["mu"],
                held["opt"]["nu"]))
    return out


COUNTERS = ("rounds", "bytes_sent", "bytes_received", "staged_bytes")


def _load_moments(opt: dict, state: dict, cfg: ArchConfig, comm,
                  expert_data: bool) -> None:
    """Fill a rank's zero AdamW state ``opt`` with its slices of the whole
    moments ``state`` ({"mu", "nu": {name: host array}, "step": int}), as
    ``shard_model`` slices the weights (a dead expert's moments stay
    zero)."""
    layout = _layout(cfg, SPECS["train"](cfg, _sizes(comm.mesh), expert_data),
                     _coords(comm.mesh, comm.rank))
    with torch.no_grad():
        for key in ("mu", "nu"):
            for name, t in opt[key].items():
                whole = torch.as_tensor(np.asarray(state[key][name]),
                                        dtype=torch.float32, device=t.device)
                t.copy_(_take(whole, layout[name]))
    opt["step"].fill_(int(state["step"]))


def rank_op(comm, payload: dict, *args):
    """One operation of the sharded LM on this rank (the ``lm`` rank
    program): ``build`` its share of the model (in place of the one it
    holds) for ``mode`` "serve" or "train"; serving: ``prefill`` a batch
    (keeping the cache for ``decode``), ``decode`` one token, or
    ``serve`` a wave through ``launch/serve.py::serve_batch``, each with
    its rows of the batch's modality stubs (``args[1]``, when given);
    training:
    ``train_init`` (AdamW's state of the rank's slices, by
    ``sharding.opt_specs``: zeros, or its slices of the whole moments
    ``args[0]``; the step's lr and micro_batch), ``train`` one step or
    ``grads`` (:func:`_train`).
    Every rank of the mesh runs the same operation; results are host
    arrays and numbers, the logits and tokens of the whole batch, with the
    operation's flash launches and the rank's collective rounds, bytes
    sent and received, and bytes staged through host buffers."""
    from repro_torch.kernels.attention import flash_attention
    from repro_torch.launch import serve
    from repro_torch.observability import registry as telemetry
    from repro_torch.train import optim
    op = payload["op"]
    dev = comm.device
    held = comm.held                   # the model and cache between runs
    if op == "build":
        held.clear()                   # the model held before, if any
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        cfg = _cfg_from_wire(payload["cfg"])
        _sync(dev)
        t0 = time.perf_counter()
        model = shard_model(cfg, comm.mesh, comm.rank,
                            seed=int(payload.get("seed", 0)),
                            params=args[0] if args else None, comm=comm,
                            mode=payload.get("mode", "serve"),
                            expert_data=bool(payload.get("expert_data")))
        _sync(dev)
        held.update(model=model, cfg=cfg,
                    expert_data=bool(payload.get("expert_data")))
        n = sum(p.numel() for p in model.parameters())
        return {"build_s": time.perf_counter() - t0, "params": n,
                "param_bytes": sum(p.numel() * p.element_size()
                                   for p in model.parameters())}
    model, cfg = held["model"], held["cfg"]
    if op == "train_init":
        opt = optim.adamw_init(model)
        if args:
            _load_moments(opt, args[0], cfg, comm, held["expert_data"])
        held.update(opt=opt, lr=float(payload["lr"]),
                    micro_batch=int(payload["micro_batch"]))
        return {"opt_bytes": sum(t.numel() * t.element_size()
                                 for k in ("mu", "nu")
                                 for t in held["opt"][k].values())}
    tokens = np.asarray(args[0])
    extras = args[1] if len(args) > 1 else None
    launches = flash_attention.launches
    counters = [telemetry.REGISTRY.counter(f"sharded.{k}") for k in COUNTERS]
    before = [c.value for c in counters]
    if op in ("train", "grads"):
        out = _train(comm, payload, tokens, extras)
    else:
        rows, data = _rows(comm, tokens.shape[0])
        _split_batch(model, data)
        local = torch.as_tensor(tokens[rows], dtype=torch.int64, device=dev)
        extras = _extras(extras, rows, dev)
        _align(dev)
    if op == "prefill":
        logits, cache = model.prefill(local, cache_len=payload.get("cache_len"),
                                      extras=extras)
        held["cache"] = cache
        out = {"logits": _gather_rows(logits, data)}
        if payload.get("return_cache"):
            out["cache"] = [_host_cache(c) for c in cache]
    elif op == "decode":
        logits, _ = model.decode_step(held["cache"], local,
                                      int(payload["pos"]))
        out = {"logits": _gather_rows(logits, data)}
    elif op == "serve":
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        toks, stats = serve.serve_batch(cfg, model, tokens[rows],
                                        int(payload["max_new"]),
                                        int(payload["cache_len"]), extras)
        out = {"tokens": _gather_rows(torch.as_tensor(toks, device=dev),
                                      data),
               "stats": stats,
               "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else 0)}
    elif op not in ("train", "grads"):
        raise ValueError(f"unknown sharded-LM operation {op!r}")
    out["flash_launches"] = flash_attention.launches - launches
    out.update(zip(COUNTERS, (c.value - b for c, b in zip(counters, before))))
    return out


# ----------------------------------------------------------- the session side
class ShardedLM:
    """An LM served or trained by one process a rank of ``mesh`` (a
    ``("data", "model")`` :class:`RankMesh`), each holding its
    :func:`shard_model` share for ``mode`` ("serve" or "train"), the
    expert stacks split over "data" with ``expert_data``; the weights
    ``init_params(cfg, seed)``'s or the JAX package's pytree ``params``.
    The layout is checked before anything is spawned.  Close it (or use
    ``with``) to stop the ranks."""

    # seconds: a rank waits this long in a collective before it fails (a
    # peer that raised), so the session hears of a fault within a run
    COLLECTIVE_TIMEOUT = 120.0
    ROUND_TIMEOUT = 900.0
    CONNECT_TIMEOUT = 120.0

    def __init__(self, cfg: ArchConfig, mesh: RankMesh, *, seed: int = 0,
                 params=None, mode: str = "serve", expert_data: bool = False):
        from repro_torch.federation import sharded
        from repro_torch.federation.distributed import Coordinator
        from repro_torch.federation.transport import RetryPolicy
        if mesh.axis_names[-2:] != (DATA_AXIS, MODEL_AXIS):
            raise ValueError(f"a sharded LM runs on a ('data', 'model') "
                             f"mesh (a leading 'pod' folded into 'data'), "
                             f"got {mesh.axis_names}")
        if mesh.abstract:
            raise ValueError("an abstract mesh (make_production_mesh) has no "
                             "devices to start ranks on: the dry run "
                             "(launch/cases.py) runs its ranks")
        if mode not in SPECS:
            raise ValueError(f"mode must be one of {tuple(SPECS)}, got "
                             f"{mode!r}")
        SPECS[mode](cfg, _sizes(mesh), expert_data)
        self.mode, self.expert_data = mode, bool(expert_data)
        self.coord = None
        if mesh.device_type == "cuda":
            # one build for every rank, before any of them needs it
            from repro_torch.kernels import attention
            attention.LIBRARY.load()
        self.mesh = mesh
        self.coord = Coordinator(mesh.size, device=mesh.devices[0],
                                 devices=mesh.devices,
                                 round_timeout=self.ROUND_TIMEOUT,
                                 connect_timeout=self.CONNECT_TIMEOUT,
                                 retry=RetryPolicy(attempts=1))
        t0 = time.perf_counter()
        self.coord.start()
        try:
            sharded.start_ranks(self.coord, mesh, self.COLLECTIVE_TIMEOUT)
            self.start_s = time.perf_counter() - t0
            self.build(cfg, seed=seed, params=params)
        except BaseException:
            self.close()
            raise

    def build(self, cfg: ArchConfig, *, seed: int = 0, params=None,
              mode: Optional[str] = None,
              expert_data: Optional[bool] = None) -> dict:
        """(Re)build the model on the running ranks — ``cfg``'s, from
        ``seed`` or the JAX package's pytree ``params``, in ``mode`` and
        ``expert_data`` (the session's when None, which they then become)
        — in place of the one they hold; each rank's build seconds,
        parameter count and bytes."""
        mode = self.mode if mode is None else mode
        expert_data = (self.expert_data if expert_data is None
                       else bool(expert_data))
        if mode not in SPECS:
            raise ValueError(f"mode must be one of {tuple(SPECS)}, got "
                             f"{mode!r}")
        SPECS[mode](cfg, _sizes(self.mesh), expert_data)
        self.cfg, self.mode, self.expert_data = cfg, mode, expert_data
        self.built = self._run({"op": "build", "seed": int(seed),
                                "mode": self.mode,
                                "expert_data": self.expert_data,
                                "cfg": dataclasses.asdict(cfg)},
                               *(() if params is None else (params,)))
        return self.built

    def _run(self, payload: dict, *args) -> dict[int, Any]:
        """``payload``'s operation on every rank: {rank: its result}."""
        ranks = range(self.mesh.size)

        def build(rid):
            return {r: {"op": "run", "run": rid, "name": "lm",
                        "payload": payload, "args": list(args),
                        "bound": None, "comm": "ranks",
                        "party_index": self.mesh.axis_index(r, MODEL_AXIS),
                        "n_parties": self.mesh.axis_size(MODEL_AXIS)}
                    for r in ranks}
        return self.coord.run_retrying(build, ranks)

    @staticmethod
    def _batch(tokens, extras: Optional[dict]) -> tuple:
        """The operation's arguments: the tokens, then the modality stubs
        (``frames`` (B, enc_frames, d), ``patches`` (B, n_patches, d), host
        arrays of the whole batch) when given; every rank takes its rows."""
        args = (np.asarray(tokens),)
        if extras:
            args += ({k: np.asarray(v) for k, v in extras.items()},)
        return args

    def prefill(self, tokens: np.ndarray, cache_len: Optional[int] = None,
                return_cache: bool = False, extras: Optional[dict] = None):
        """(B, V) last-position logits of the batch (with its modality
        stubs ``extras``), and each rank's result (its cache, its own kv
        heads — a cross-attention layer's {"self": ring, "cross": {k, v}} —
        with ``return_cache``; its flash launches).  The cache stays on the
        ranks for :meth:`decode`."""
        out = self._run({"op": "prefill", "cache_len": cache_len,
                         "return_cache": bool(return_cache)},
                        *self._batch(tokens, extras))
        return out[0]["logits"], out

    def decode(self, token: np.ndarray, pos: int) -> np.ndarray:
        """(B, V) logits of one decode step at absolute position ``pos``
        against the cache the last :meth:`prefill` left (its cross k, v
        too: a decode step embeds no stub)."""
        return self._run({"op": "decode", "pos": int(pos)},
                         np.asarray(token))[0]["logits"]

    def serve(self, prompts: np.ndarray, max_new: int, cache_len: int,
              extras: Optional[dict] = None):
        """One ``serve_batch`` wave on every rank (with the prompts'
        modality stubs ``extras``): rank 0's (B, max_new)
        greedy tokens (the whole batch's) and stats — prefill and decode
        seconds the slowest rank's, decode tokens/s the whole batch's —
        with every rank's flash launches, peak device bytes, collective
        rounds, bytes sent and received and bytes staged (lists in rank
        order)."""
        out = self._run({"op": "serve", "max_new": int(max_new),
                         "cache_len": int(cache_len)},
                        *self._batch(prompts, extras))
        stats = dict(out[0]["stats"])
        for key in ("prefill_s", "decode_s"):     # the slowest rank's
            stats[key] = max(out[r]["stats"][key] for r in out)
        stats["decode_tok_s"] = (len(prompts) * (max_new - 1)
                                 / max(stats["decode_s"], 1e-9))
        for key in ("flash_launches", "peak_bytes", *COUNTERS):
            stats[key] = [out[r][key] for r in sorted(out)]
        stats["logits_finite"] = all(out[r]["stats"]["logits_finite"]
                                     for r in out)
        return out[0]["tokens"], stats

    def train_init(self, *, lr: float = 3e-4, micro_batch: int = 0,
                   state: Optional[dict] = None) -> dict:
        """AdamW's state on every rank (μ and ν of its slices, as
        ``sharding.opt_specs`` lays them out): zeros, or the rank's slices
        of the whole moments ``state`` ({"mu", "nu": {parameter name:
        array}, "step": int}, the unsharded ``adamw_init`` / ``adamw_update``
        state on the host) — and the step's ``lr`` and ``micro_batch`` (of
        the global batch; 0: one backward pass); each rank's μ + ν bytes."""
        if self.mode != "train":
            raise ValueError("train_init needs a ShardedLM built with "
                             "mode='train'")
        args = ()
        if state is not None:
            args = ({"step": int(state["step"]),
                     **{k: {n: np.asarray(v, np.float32)
                            for n, v in state[k].items()}
                        for k in ("mu", "nu")}},)
        out = self._run({"op": "train_init", "lr": float(lr),
                         "micro_batch": int(micro_batch)}, *args)
        return {r: out[r]["opt_bytes"] for r in sorted(out)}

    def _train_run(self, op: str, tokens, extras: Optional[dict] = None,
                   return_state: bool = False, stride: int = 1,
                   profile: bool = False):
        out = self._run({"op": op, "return_state": bool(return_state),
                         "stride": int(stride), "profile": bool(profile)},
                        *self._batch(tokens, extras))
        ranks = sorted(out)
        stats = {k: out[0][k] for k in ("loss", "ce", "aux")}
        stats["step_s"] = max(out[r]["step_s"] for r in ranks)
        for key in ("peak_bytes", "gathered_peak_bytes", "gathered_leaves",
                    "flash_launches", *COUNTERS):
            stats[key] = [out[r][key] for r in ranks]
        if profile:
            stats["device_ms"] = [out[r]["device_ms"] for r in ranks]
        return stats, out

    def train_step(self, tokens: np.ndarray, return_state: bool = False,
                   profile: bool = False, extras: Optional[dict] = None):
        """One training step on the (B, S) batch ``tokens`` and its
        modality stubs ``extras`` (every rank takes its rows of each
        microbatch): the whole batch's loss, CE and aux (rank 0's;
        every rank holds them), the slowest rank's step seconds, and each
        rank's peak device bytes, peak bytes of gathered FSDP weights and
        the leaf names gathered, flash launches, collective rounds and
        bytes (lists in rank order),
        with ``profile`` its device milliseconds by kind (``device_ms``: the
        step under ``torch.profiler``); and each rank's result — its
        parameter, μ and ν slices (float32 host arrays) with
        ``return_state``."""
        return self._train_run("train", tokens, extras, return_state,
                               profile=profile)

    def grads(self, tokens: np.ndarray, stride: int = 1,
              extras: Optional[dict] = None):
        """:meth:`train_step`'s statistics and each rank's result with its
        reduced gradient slices (``grads``; :func:`rank_slices` places them;
        with ``stride`` > 1 every ``stride``-th element of each flattened
        slice), without an update."""
        return self._train_run("grads", tokens, extras, stride=stride)

    def close(self) -> None:
        if self.coord is not None:
            self.coord.shutdown()
            self.coord = None

    def __enter__(self) -> "ShardedLM":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
