"""Tensor- and expert-parallel serving of an LM over a ``("data", "model")``
rank mesh, laid out by ``models/sharding.py::param_specs(mode="serve")``.

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
    own, not this one).

A contiguous split of q heads and kv heads keeps the JAX package's
grouping (q head h reads kv head h // G) only when the model axis divides
the kv heads; a layout whose sharded projection falls off a head boundary
raises NotImplementedError (:func:`serve_specs`), as do the families the
sharded forward does not run (recurrent blocks, the encoder-decoder and
the VLM).

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
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import DATA_AXIS, MODEL_AXIS, RankMesh
from repro_torch.models import layers, sharding, transformer

_ATTN_LEAVES = (("wq", -1, "n_heads"), ("wk", -1, "n_kv_heads"),
                ("wv", -1, "n_kv_heads"), ("wo", -2, "n_heads"))


def _sizes(mesh: RankMesh) -> dict[str, int]:
    return {DATA_AXIS: mesh.axis_size(DATA_AXIS),
            MODEL_AXIS: mesh.axis_size(MODEL_AXIS)}


def serve_specs(cfg: ArchConfig, axis_sizes) -> dict[str, tuple]:
    """``sharding.param_specs(mode="serve")`` of ``cfg``'s parameters at
    ``axis_sizes``, after checking that the sharded forward runs that
    layout: NotImplementedError names the config and the leaf otherwise."""
    kinds = set(transformer.layer_kinds(cfg))
    if kinds - {"attn"} or cfg.enc_layers or cfg.n_patches:
        raise NotImplementedError(
            f"{cfg.name}: the sharded forward runs decoder-only attention "
            f"models (dense and MoE); block kinds {sorted(kinds)}, "
            f"{cfg.enc_layers} encoder layers, {cfg.n_patches} patches")
    meta = transformer.Transformer(cfg, "meta")
    specs = sharding.param_specs(meta, axis_sizes, mode="serve")
    m = axis_sizes[MODEL_AXIS]
    for prefix, mod in meta.named_modules():
        if isinstance(mod, layers.Attention):
            on = {leaf: MODEL_AXIS in specs[f"{prefix}.{leaf}"][dim:][:1]
                  for leaf, dim, _ in _ATTN_LEAVES}
            if not any(on.values()):
                continue
            for leaf, _, heads in _ATTN_LEAVES:
                if not on[leaf] or getattr(cfg, heads) % m:
                    raise NotImplementedError(
                        f"{cfg.name}: {prefix}.{leaf} at model = {m} does "
                        f"not split on a head boundary ({cfg.n_heads} q "
                        f"heads on {cfg.n_kv_heads} kv heads of "
                        f"{cfg.head_dim})")
        elif isinstance(mod, layers.MLP):
            on = [MODEL_AXIS in specs[f"{prefix}.{leaf}"]
                  for leaf in ("wg", "wu", "wd")]
            if len(set(on)) > 1:
                raise NotImplementedError(
                    f"{cfg.name}: {prefix} is split in part at model = {m}")
    return specs


def _slices(spec: tuple, shape, index: int, size: int) -> tuple:
    """The part of a leaf of ``shape`` that model shard ``index`` of
    ``size`` holds under ``spec``."""
    out = []
    for dim, n in enumerate(shape):
        if dim < len(spec) and spec[dim] == MODEL_AXIS:
            k = n // size
            out.append(slice(index * k, (index + 1) * k))
        else:
            out.append(slice(None))
    return tuple(out)


def _local_model(cfg: ArchConfig, specs: dict, index: int, size: int,
                 device) -> transformer.Transformer:
    """A model whose every parameter has the shape of its slice, on
    ``device``, uninitialised."""
    model = transformer.Transformer(cfg, "meta")
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        shape = [s.stop - s.start if s.start is not None else n
                 for s, n in zip(_slices(specs[name], p.shape, index, size),
                                 p.shape)]
        setattr(model.get_submodule(owner), leaf,
                layers.empty_param(shape, p.dtype, device))
    return model


def shard_model(cfg: ArchConfig, mesh: RankMesh, rank: int, *, seed: int = 0,
                params=None, comm=None) -> transformer.Transformer:
    """Rank ``rank``'s share of ``cfg``'s model on ``mesh``: its slices of
    the weights by :func:`serve_specs`, on its device, its modules bound
    to ``comm`` (the rank's ``federation/sharded.py::DistComm`` over its
    model axis, the data axis's under ``comm.axes["data"]``).

    The weights are ``transformer.init_params(cfg, seed)``'s, drawn leaf
    by leaf on the rank's device, or the JAX package's pytree ``params``
    (``convert.lm_param_leaves``).  Without ``comm`` the model axis must
    be 1 and the model runs alone."""
    from repro_torch import convert
    sizes = _sizes(mesh)
    size = sizes[MODEL_AXIS]
    if comm is None and size > 1:
        raise ValueError(f"a model axis of {size} needs the rank's comm")
    specs = serve_specs(cfg, sizes)
    index = mesh.axis_index(rank, MODEL_AXIS)
    dev = torch.device(mesh.devices[rank])
    model = _local_model(cfg, specs, index, size, dev)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        leaves = transformer.draw_params(cfg, gen, dev)
    else:
        leaves = convert.lm_param_leaves(params, cfg, dev)
    with torch.no_grad():
        for name, value in leaves:
            dst = model.get_parameter(name)
            dst.copy_(value[_slices(specs[name], value.shape, index, size)])
            del value
    if comm is not None:
        _bind(model, specs, comm, index)
    return model


def _bind(model: transformer.Transformer, specs: dict, comm,
          index: int) -> None:
    """Give each module whose weights are sharded the model axis's comm
    (and an MoE its first expert)."""
    model.tp = comm
    for prefix, mod in model.named_modules():
        if isinstance(mod, (layers.Attention, layers.MLP)):
            row = "wo" if isinstance(mod, layers.Attention) else "wd"
            if MODEL_AXIS in specs[f"{prefix}.{row}"]:
                mod.tp = comm
        elif isinstance(mod, layers.MoE):
            spec = specs[f"{prefix}.we_down"]
            if spec[:1] == (MODEL_AXIS,):
                mod.expert_offset = index * mod.we_down.shape[0]
            if MODEL_AXIS in spec:
                mod.tp = comm


def _split_batch(model: transformer.Transformer, data) -> None:
    """Route the MoE layers over the whole batch when ``data`` (the data
    axis's comm) splits it, over this rank's rows otherwise."""
    for mod in model.modules():
        if isinstance(mod, layers.MoE):
            mod.data = data


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
    t = t if data is None else data.all_gather_cat(t, 0)
    return t.cpu().numpy()


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def rank_op(comm, payload: dict, *args):
    """One operation of the sharded LM on this rank (the ``lm`` rank
    program): ``build`` its share of the model (in place of the one it
    holds), ``prefill`` a batch (keeping the cache for ``decode``),
    ``decode`` one token, or ``serve`` a wave through
    ``launch/serve.py::serve_batch``.
    Every rank of the mesh runs the same operation; results are host
    arrays and numbers, the logits and tokens of the whole batch, with the
    operation's flash launches and the rank's collective rounds and bytes
    staged through host buffers."""
    from repro_torch.kernels.attention import flash_attention
    from repro_torch.launch import serve
    from repro_torch.observability import registry as telemetry
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
                            params=args[0] if args else None, comm=comm)
        _sync(dev)
        held.update(model=model, cfg=cfg)
        n = sum(p.numel() for p in model.parameters())
        return {"build_s": time.perf_counter() - t0, "params": n,
                "param_bytes": sum(p.numel() * p.element_size()
                                   for p in model.parameters())}
    model, cfg = held["model"], held["cfg"]
    tokens = np.asarray(args[0])
    rows, data = _rows(comm, tokens.shape[0])
    _split_batch(model, data)
    local = torch.as_tensor(tokens[rows], dtype=torch.int64, device=dev)
    launches = flash_attention.launches
    counters = [telemetry.REGISTRY.counter(f"sharded.{k}")
                for k in ("rounds", "staged_bytes")]
    before = [c.value for c in counters]
    if op == "prefill":
        logits, cache = model.prefill(local, cache_len=payload.get("cache_len"))
        held["cache"] = cache
        out = {"logits": _gather_rows(logits, data)}
        if payload.get("return_cache"):
            out["cache"] = [{k: v.cpu().numpy() for k, v in c.items()}
                            for c in cache]
    elif op == "decode":
        logits, _ = model.decode_step(held["cache"], local,
                                      int(payload["pos"]))
        out = {"logits": _gather_rows(logits, data)}
    elif op == "serve":
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        toks, stats = serve.serve_batch(cfg, model, tokens[rows],
                                        int(payload["max_new"]),
                                        int(payload["cache_len"]))
        out = {"tokens": _gather_rows(torch.as_tensor(toks, device=dev),
                                      data),
               "stats": stats,
               "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else 0)}
    else:
        raise ValueError(f"unknown sharded-LM operation {op!r}")
    out["flash_launches"] = flash_attention.launches - launches
    out["rounds"], out["staged_bytes"] = (c.value - b for c, b in
                                          zip(counters, before))
    return out


# ----------------------------------------------------------- the session side
class ShardedLM:
    """An LM served by one process a rank of ``mesh`` (a ``("data",
    "model")`` :class:`RankMesh`), each holding its :func:`shard_model`
    share; the weights ``init_params(cfg, seed)``'s or the JAX package's
    pytree ``params``.  The layout is checked before anything is spawned.
    Close it (or use ``with``) to stop the ranks."""

    # seconds: a rank waits this long in a collective before it fails (a
    # peer that raised), so the session hears of a fault within a run
    COLLECTIVE_TIMEOUT = 120.0
    ROUND_TIMEOUT = 900.0
    CONNECT_TIMEOUT = 120.0

    def __init__(self, cfg: ArchConfig, mesh: RankMesh, *, seed: int = 0,
                 params=None):
        from repro_torch.federation import sharded
        from repro_torch.federation.distributed import Coordinator
        from repro_torch.federation.transport import RetryPolicy
        if mesh.axis_names != (DATA_AXIS, MODEL_AXIS):
            raise ValueError(f"a sharded LM runs on a ('data', 'model') "
                             f"mesh, got {mesh.axis_names}")
        serve_specs(cfg, _sizes(mesh))
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

    def build(self, cfg: ArchConfig, *, seed: int = 0, params=None) -> dict:
        """(Re)build the model on the running ranks — ``cfg``'s, from
        ``seed`` or the JAX package's pytree ``params`` — in place of the
        one they hold; each rank's build seconds, parameter count and
        bytes."""
        serve_specs(cfg, _sizes(self.mesh))
        self.cfg = cfg
        self.built = self._run({"op": "build", "seed": int(seed),
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

    def prefill(self, tokens: np.ndarray, cache_len: Optional[int] = None,
                return_cache: bool = False):
        """(B, V) last-position logits of the batch, and each rank's
        result (its cache, its own kv heads, with ``return_cache``; its
        flash launches).  The cache stays on the ranks for
        :meth:`decode`."""
        out = self._run({"op": "prefill", "cache_len": cache_len,
                         "return_cache": bool(return_cache)},
                        np.asarray(tokens))
        return out[0]["logits"], out

    def decode(self, token: np.ndarray, pos: int) -> np.ndarray:
        """(B, V) logits of one decode step at absolute position ``pos``
        against the cache the last :meth:`prefill` left."""
        return self._run({"op": "decode", "pos": int(pos)},
                         np.asarray(token))[0]["logits"]

    def serve(self, prompts: np.ndarray, max_new: int, cache_len: int):
        """One ``serve_batch`` wave on every rank: rank 0's (B, max_new)
        greedy tokens (the whole batch's) and stats — prefill and decode
        seconds the slowest rank's, decode tokens/s the whole batch's —
        with every rank's flash launches, peak device bytes, collective
        rounds and staged bytes (lists in rank order)."""
        out = self._run({"op": "serve", "max_new": int(max_new),
                         "cache_len": int(cache_len)}, np.asarray(prompts))
        stats = dict(out[0]["stats"])
        for key in ("prefill_s", "decode_s"):     # the slowest rank's
            stats[key] = max(out[r]["stats"][key] for r in out)
        stats["decode_tok_s"] = (len(prompts) * (max_new - 1)
                                 / max(stats["decode_s"], 1e-9))
        for key in ("flash_launches", "peak_bytes", "rounds", "staged_bytes"):
            stats[key] = [out[r][key] for r in sorted(out)]
        stats["logits_finite"] = all(out[r]["stats"]["logits_finite"]
                                     for r in out)
        return out[0]["tokens"], stats

    def close(self) -> None:
        if self.coord is not None:
            self.coord.shutdown()
            self.coord = None

    def __enter__(self) -> "ShardedLM":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
