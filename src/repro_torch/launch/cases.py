"""Dry-run cases: (arch × input shape × mesh) -> one rank's step on fake
tensors, counted.

The port's counterpart of the JAX package's ``launch/cases.py``.  There a
case is a jitted step lowered on a device mesh from ``ShapeDtypeStruct``
stand-ins; here it is the port's own step — a prefill, a decode step, or
a training step with AdamW — run by one rank of the mesh under
``FakeTensorMode`` on device ``cuda`` (:data:`FAKE_DEVICE`) and counted by
``op_analysis.OpCounter``.  No weight is drawn and no card is needed: the
rank's shard of the model is built from the meta model
(``models/parallel.py::shard_model(draw=False)``), and its comms are
``op_analysis.FakeComm`` s that return tensors of the right shapes and
tally what ``DistComm`` would have sent.  A 256- or 512-rank mesh thus
runs in one CPU process, a rank at a time.

The ranks of a mesh differ where the model axis splits heads unevenly
(``parallel.head_run``), so each distinct rank layout runs once
(:meth:`Case.layouts`), and the case's record keeps the rank with the
largest least time (``roofline.Roofline.least_s``).

The forest cases (:func:`forest_case`) run one rank of the sharded
substrate's fit or predict program the same way.  A case that reaches an
op whose result the host must read (a data-dependent shape or branch)
fails, and the failure names the op; nothing is guessed.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Optional

import torch

from repro_torch import op_analysis, roofline
from repro_torch.configs import registry
from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import DATA_AXIS, MODEL_AXIS, RankMesh


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    kind: str          # train | prefill | decode
    seq: int
    batch: int
    subquadratic: bool = False   # long-context: require sub-quadratic path


SHAPES: dict[str, InputShape] = {
    "train_4k":    InputShape("train_4k", "train", 4_096, 256),
    "prefill_32k": InputShape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k":  InputShape("decode_32k", "decode", 32_768, 128),
    "long_500k":   InputShape("long_500k", "decode", 524_288, 1, True),
}

# principled skips (the JAX package's, word for word)
SKIPS: dict[tuple[str, str], str] = {
    ("whisper-large-v3", "long_500k"):
        "enc-dec audio: decoder caps at 448 tokens; no faithful "
        "sub-quadratic variant of cross+self attention at 500k",
}

SWA_WINDOW = 4_096
TRAIN_MICRO_BATCH = 8


class Skip(Exception):
    pass


def arch_for_shape(arch: str, shape: InputShape) -> ArchConfig:
    """Resolve the per-shape config variant (e.g. SWA for long_500k)."""
    if (arch, shape.name) in SKIPS:
        raise Skip(SKIPS[(arch, shape.name)])
    cfg = registry.get(arch)
    if shape.subquadratic and not cfg.is_subquadratic:
        # sliding-window variant for the attention blocks (hybrid archs keep
        # full recurrent state in their SSM blocks)
        cfg = cfg.with_(sliding_window=SWA_WINDOW)
    return cfg


# The device of the fake tensors: the card's where this build of torch has
# CUDA; a CPU-only build cannot take the device guard for "cuda" that
# Python indexing takes, so there they are on the CPU.  The ops, and every
# count, are the same (``models/`` branches on no device).
FAKE_DEVICE = "cuda" if torch.backends.cuda.is_built() else "cpu"


def _on_fake_device(mesh: RankMesh) -> RankMesh:
    return dataclasses.replace(mesh, devices=(FAKE_DEVICE,) * mesh.size)


def _fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode(allow_non_fake_inputs=False)


def _comms(mesh: RankMesh, rank: int, tally):
    """Rank ``rank``'s model-axis :class:`~op_analysis.FakeComm`, with its
    data axis's under ``axes["data"]``, both tallying into ``tally`` what
    ``DistComm`` counts on the mesh's backend."""
    def group(name):
        return next(g for g in mesh.axis_ranks(name) if rank in g)
    kw = dict(rank=rank, backend=mesh.backend, device=FAKE_DEVICE)
    data = op_analysis.FakeComm(group(DATA_AXIS),
                                mesh.axis_index(rank, DATA_AXIS), tally, **kw)
    comm = op_analysis.FakeComm(group(MODEL_AXIS),
                                mesh.axis_index(rank, MODEL_AXIS), tally,
                                **kw)
    comm.axes[DATA_AXIS] = data
    return comm


class _Marked:
    """``model`` as AdamW's update reads it (``named_parameters``), marking
    the counter's peak after each leaf's update under the leaf's name with
    its layer index dropped (``adamw:blocks.*.attn.wq``): the update of a
    later layer's leaf peaks higher (more new moments alive), so each
    name's largest is its last layer's, which grows by the same bytes a
    unit."""

    def __init__(self, model, counter: op_analysis.OpCounter):
        self.model, self.counter = model, counter

    def named_parameters(self):
        for name, p in self.model.named_parameters():
            yield name, p
            self.counter.mark("adamw:" + ".".join(
                "*" if part.isdigit() else part for part in name.split(".")))


@dataclasses.dataclass
class RankRun:
    """One rank's counted step: its counts (:func:`_counts`: FLOPs by
    dtype, bytes, peak live bytes, the collectives' tallies, the kernels'
    calls), its roofline and its parameter count."""

    rank: int
    counts: dict
    params: int

    @property
    def roofline(self) -> roofline.Roofline:
        c = self.counts
        by_dtype = {k[6:]: v for k, v in c.items() if k.startswith("flops:")}
        detail: dict = {}
        for k, v in c.items():
            if k.startswith("coll:"):
                _, kind, field = k.split(":")
                detail.setdefault(kind, {})[field] = v
        return roofline.Roofline(
            flops=sum(by_dtype.values()), hbm_bytes=c["bytes"],
            coll_bytes=sum(d["bytes"] for d in detail.values()),
            coll_detail=detail, per_device_memory=max(self.count(
                "peak:").values()),
            flops_by_dtype=by_dtype,
            coll_time=sum(d["seconds"] for d in detail.values()))

    def count(self, prefix: str) -> dict:
        return {k[len(prefix):]: v for k, v in self.counts.items()
                if k.startswith(prefix)}


def _counts(counter: op_analysis.OpCounter) -> dict:
    marks = counter.marks or {"step": counter.peak_bytes}
    out = {"bytes": counter.bytes,
           **{f"peak:{k}": v for k, v in marks.items()}}
    out.update({f"flops:{k}": v for k, v in counter.flops_by_dtype.items()})
    for kind, d in counter.collectives.detail().items():
        out.update({f"coll:{kind}:{f}": v for f, v in d.items()})
    out.update({f"kernel:{k}": v for k, v in counter.kernel_calls.items()})
    return out


def _through(at: dict, x: float) -> dict:
    """Counts at ``x`` on the polynomial through the points ``at`` (x ->
    counts): the line through two, the parabola through three; each
    region's peak on the line through the last two (a peak grows by what
    each unit, microbatch or chunk keeps alive)."""
    keys = set().union(*at.values())
    out = dict.fromkeys(keys, 0.0)
    last = dict(sorted(at.items())[-2:])
    for k in keys:
        pts = last if k.startswith("peak:") else at
        for xi, counts in pts.items():
            w = math.prod((x - xj) / (xi - xj) for xj in pts if xj != xi)
            out[k] += w * counts.get(k, 0)
    return out


@dataclasses.dataclass
class Case:
    """One (arch × shape × mesh) step: ``mode`` "train" or "serve" layout
    (``parallel.SPECS``), the training microbatch ``micro_batch`` (of the
    global batch), ``expert_data``; :meth:`run` counts one rank's step.

    Every pattern unit of a model runs the same ops, and so does every
    microbatch of a training step (and every chunk of sequence of a model
    of recurrent blocks only), so a deep model's counts are taken at 2 and
    3 units (a training step's at 2 and 3 microbatches, a recurrent
    model's at 1, 2 and 3 chunks, and 1 and 2 units) and extrapolated
    along each axis to the config's depth (microbatch count, sequence):
    exact for FLOPs, bytes, collectives and kernel calls (xLSTM's bytes
    within 0.1 %).  The peak is taken in each region of the step (a
    training step's backward and each leaf's AdamW update, whose peaks
    grow by different bytes a unit: :class:`_Marked`), each carried on
    its own line, and the largest kept (``tests/test_torch_dryrun.py``
    holds both against whole runs).  ``exact=True`` runs the whole
    step."""

    arch: str
    shape: InputShape
    cfg: ArchConfig
    mesh: RankMesh
    mode: str
    micro_batch: int = 0
    expert_data: bool = False
    cache_len: Optional[int] = None      # prefill's ring; None: the prompt's
    decode_steps: int = 1                # decode steps after a prefill
    points: int = 0                      # the runs the last count took

    def layouts(self) -> list[list[int]]:
        """The model ranks that share each distinct rank layout (the local
        shape of every parameter), in rank order of their first: a rank of
        each runs (data shard 0's)."""
        from repro_torch.models import parallel, transformer
        specs = parallel.SPECS[self.mode](self.cfg, parallel._sizes(self.mesh),
                                          self.expert_data)
        meta = dict(transformer.Transformer(self.cfg, "meta")
                    .named_parameters())
        m = self.mesh.axis_size(MODEL_AXIS)
        groups: dict[tuple, list[int]] = {}
        for j in range(m):
            lay = parallel._layout(self.cfg, specs, parallel._coords(
                self.mesh, j))
            key = tuple(tuple(parallel._extent(lay[n], p.shape))
                        for n, p in meta.items())
            groups.setdefault(key, []).append(j)
        return list(groups.values())

    def _batch(self, rows, seq: int) -> dict:
        cfg, dev = self.cfg, FAKE_DEVICE
        out = {"tokens": torch.zeros((rows, seq), dtype=torch.int64,
                                     device=dev)}
        dt = getattr(torch, cfg.dtype)
        if cfg.enc_layers:
            out["frames"] = torch.zeros((rows, cfg.enc_frames, cfg.d_model),
                                        dtype=dt, device=dev)
        if cfg.n_patches:
            out["patches"] = torch.zeros((rows, cfg.n_patches, cfg.d_model),
                                         dtype=dt, device=dev)
        return out

    def _at_units(self, k: int) -> ArchConfig:
        """The config cut to ``k`` pattern units (its tail kept; an
        encoder's layers cut in step)."""
        cfg = self.cfg
        kw = {"n_layers": k * len(cfg.pattern) + len(cfg.tail_blocks)}
        if cfg.enc_layers:
            kw["enc_layers"] = k * cfg.enc_layers // cfg.n_units
        return cfg.with_(**kw)

    def run(self, rank: int = 0, exact: bool = False,
            fake: bool = True) -> RankRun:
        """Rank ``rank``'s step counted: at the config's depth and
        microbatch count with ``exact``, else extrapolated from 2 and 3
        units and 2 and 3 microbatches (one microbatch takes another path)
        — and, for a model of recurrent blocks only (xLSTM's time loop),
        from 1, 2 and 3 chunks of sequence on a parabola (a step's
        backward through ``pre[:, t]`` builds a whole-sequence gradient
        each step: bytes quadratic in the sequence), with 1 and 2 units —
        along each axis in turn (the class docstring)."""
        cfg, shape = self.cfg, self.shape
        units = cfg.n_units
        n_micro = (shape.batch // self.micro_batch
                   if shape.kind == "train" and self.micro_batch else 1)
        chunk = cfg.ssm_chunk
        recurrent = (cfg.is_subquadratic and shape.kind != "decode"
                     and shape.seq > 3 * chunk and shape.seq % chunk == 0)
        up = (1, 2) if recurrent else (2, 3)
        dims = {  # name -> (the target, the points it is extrapolated from)
            "units": (units, up if units > up[1] and (
                not cfg.enc_layers or cfg.enc_layers % units == 0) else None),
            "micro": (n_micro, (2, 3) if n_micro > 3 else None),
            "seq": (shape.seq, (chunk, 2 * chunk, 3 * chunk)
                    if recurrent else None)}
        if exact:
            dims = {k: (t, None) for k, (t, _) in dims.items()}
        grid = [()]
        for target, points in dims.values():
            grid = [g + (p,) for g in grid for p in (points or (target,))]
        at = {}
        for u, n, seq in grid:
            at[u, n, seq] = self._run(
                rank, self._at_units(u) if u != units else cfg,
                n * self.micro_batch if n != n_micro else shape.batch,
                seq, fake).counts
        for axis, (target, points) in enumerate(dims.values()):
            if points is None:
                continue
            lines: dict = {}
            for key, counts in at.items():
                rest = key[:axis] + key[axis + 1:]
                lines.setdefault(rest, {})[key[axis]] = counts
            at = {rest[:axis] + (target,) + rest[axis:]:
                  _through(line, target) for rest, line in lines.items()}
        self.points = len(grid)
        return RankRun(rank, next(iter(at.values())), self._params(rank))

    def _params(self, rank: int) -> int:
        from repro_torch.models import parallel, transformer
        specs = parallel.SPECS[self.mode](self.cfg, parallel._sizes(self.mesh),
                                          self.expert_data)
        lay = parallel._layout(self.cfg, specs,
                               parallel._coords(self.mesh, rank))
        return sum(math.prod(parallel._extent(lay[n], p.shape)) for n, p in
                   transformer.Transformer(self.cfg, "meta")
                   .named_parameters())

    def _run(self, rank: int, cfg: ArchConfig, batch_size: int,
             seq: int, fake: bool = True) -> RankRun:
        """Rank ``rank``'s step of ``cfg`` on a global batch of
        ``batch_size`` rows of ``seq`` on fake tensors (real ones, their
        weights unset, without ``fake``) under an
        :class:`~op_analysis.OpCounter`: its model, optimizer state and
        inputs (the step's arguments) tracked, then the step counted."""
        from repro_torch.models import parallel
        from repro_torch.train import optim, step
        counter = op_analysis.OpCounter()
        shape = self.shape
        mesh = _on_fake_device(self.mesh)
        with _fake_mode() if fake else contextlib.nullcontext():
            comm = _comms(mesh, rank, counter.collectives)
            model = parallel.shard_model(cfg, mesh, rank, comm=comm,
                                         mode=self.mode,
                                         expert_data=self.expert_data,
                                         draw=False)
            counter.track(model)
            if shape.kind == "train":
                idx, local_mb, data = parallel._train_rows(
                    comm, batch_size, self.micro_batch)
                parallel._split_batch(model, data)
                opt = optim.adamw_init(model)
                batch = self._batch(len(idx), seq)
                counter.track(opt, batch)
                # make_train_step's two halves, the backward's peak and that
                # of each leaf's AdamW update kept (their peaks grow by
                # different bytes a unit: _Marked)
                with counter:
                    names, grads, _ = step.accumulate_grads(model, batch,
                                                            local_mb)
                    counter.mark("backward")
                    optim.adamw_update(_Marked(model, counter),
                                       dict(zip(names, grads)), opt, lr=3e-4)
            else:
                rows, data = parallel._rows(comm, batch_size)
                parallel._split_batch(model, data)
                n = len(range(batch_size)[rows])
                if shape.kind == "prefill":
                    batch = self._batch(n, seq)
                    counter.track(batch)
                    extras = {k: v for k, v in batch.items()
                              if k != "tokens"}
                    with counter, torch.no_grad():
                        _, cache = model.prefill(
                            batch["tokens"], cache_len=self.cache_len,
                            extras=extras)
                        self._decode(model, cache, batch["tokens"],
                                     seq, self.decode_steps - 1)
                else:
                    # a cache of the prompt's length (its ring capped at a
                    # window), made outside the count: the step's argument
                    batch = self._batch(n, max(cfg.n_patches, 1))
                    extras = {k: v for k, v in batch.items()
                              if k != "tokens"}
                    with torch.no_grad():
                        _, cache = model.prefill(batch["tokens"],
                                                 cache_len=seq,
                                                 extras=extras)
                    counter.track(cache, batch)
                    with counter, torch.no_grad():
                        self._decode(model, cache, batch["tokens"],
                                     seq - 1, self.decode_steps)
        return RankRun(rank, _counts(counter), 0)

    @staticmethod
    def _decode(model, cache, tokens, pos: int, steps: int) -> None:
        """``steps`` greedy decode steps from position ``pos``, as
        ``launch/serve.py::serve_batch`` takes them."""
        tok = tokens[:, -1:]
        for i in range(steps):
            logits, cache = model.decode_step(cache, tok, pos + i)
            tok = logits.argmax(-1)[:, None]

    def analyze(self, exact: bool = False) -> dict[str, Any]:
        """Each distinct layout's rank run once: the record of the rank with
        the largest least time (its summary, the model FLOPs share), each
        layout's model ranks, peak GiB and least time, and the kernels'
        calls."""
        runs = [(ranks, self.run(ranks[0], exact))
                for ranks in self.layouts()]
        ranks, worst = max(runs, key=lambda x: (x[1].roofline.least_s,
                                               x[1].roofline.per_device_memory))
        mf = roofline.model_flops(self.cfg, self.shape.kind, self.shape.batch,
                                  self.shape.seq)
        return _record(worst, mf, self.mesh.size,
                       layouts=[{"model_ranks": rk,
                                 "mem_per_dev_gib":
                                     r.roofline.per_device_memory / 2**30,
                                 "least_s": r.roofline.least_s}
                                for rk, r in runs])


def _record(run: RankRun, model_flops: float, n_chips: int, **extra) -> dict:
    ro = run.roofline
    coll = ro.coll_detail
    return {"roofline": ro.summary(model_flops_global=model_flops,
                                   n_chips=n_chips),
            "collectives": coll, "rank": run.rank,
            "rounds": sum(d.get("count", 0) for d in coll.values()),
            "bytes_sent": sum(d.get("bytes_sent", 0) for d in coll.values()),
            "bytes_received": sum(d.get("bytes_received", 0)
                                  for d in coll.values()),
            "kernel_calls": run.count("kernel:"),
            "peak_regions": dict(sorted(run.count("peak:").items(),
                                        key=lambda kv: -kv[1])[:3]),
            "params_per_rank": run.params, **extra}


def input_specs(arch: str, shape_name: str, mesh: RankMesh,
                overrides: Optional[dict] = None,
                micro_batch: Optional[int] = None,
                serve_layout: Optional[bool] = None,
                expert_data: bool = False) -> Case:
    """The (arch × shape) case on ``mesh``, the JAX package's arguments:

    ``overrides``: ArchConfig field overrides (the perf variants).
    ``micro_batch``: the training microbatch (of the global batch);
    ``TRAIN_MICRO_BATCH`` (or the batch) by default, as JAX's.
    ``serve_layout``: prefill and decode on the tensor-parallel serve
    layout; by default they run on the train layout (FSDP × tensor), as
    the JAX package's dry run lowers them.
    ``expert_data``: the expert stacks over "data"."""
    shape = SHAPES[shape_name]
    cfg = arch_for_shape(arch, shape)
    if overrides:
        cfg = cfg.with_(**overrides)
    if shape.kind == "train":
        return Case(arch, shape, cfg, mesh, "train",
                    micro_batch or min(TRAIN_MICRO_BATCH, shape.batch),
                    expert_data)
    return Case(arch, shape, cfg, mesh, "serve" if serve_layout else "train",
                0, expert_data)


# --------------------------------------------------- federated forest case
@dataclasses.dataclass(frozen=True)
class ForestShape:
    name: str
    n_samples: int
    n_feat_per_party: int
    n_trees_per_shard: int
    n_test: int = 0


FOREST_SHAPES = {
    "ff_train": ForestShape("ff_train", 262_144, 16, 4),
    "ff_predict": ForestShape("ff_predict", 262_144, 16, 4, n_test=65_536),
}


@dataclasses.dataclass
class ForestCase:
    """One rank of the sharded substrate's forest program on ``mesh`` (a
    ``("trees", "parties")`` mesh, a leading "pod" replicating): the fit
    (``federation/distributed.py::_forest_fit_body``'s trees, over the
    rank's party's columns) or the one-round predict over the rank's tree
    shard (``federation/sharded.py::_forest_predict_trees_body``), on fake
    tensors, its comm a :class:`~op_analysis.FakeComm` over the rank's
    parties."""

    shape: ForestShape
    mesh: RankMesh
    params: Any
    hist_impl: str = "cuda"
    predict_kw: dict = dataclasses.field(default_factory=dict)

    def run(self, rank: int = 0) -> RankRun:
        from repro_torch.core import prediction, tree
        from repro_torch.core.tree import PartyTree
        from repro_torch.core.types import PARTY_AXIS
        counter = op_analysis.OpCounter()
        fs, p, dev = self.shape, self.params, FAKE_DEVICE
        m = self.mesh.axis_size(PARTY_AXIS)
        n, fp, t = fs.n_samples, fs.n_feat_per_party, fs.n_trees_per_shard
        with _fake_mode():
            group = next(g for g in self.mesh.axis_ranks(PARTY_AXIS)
                         if rank in g)
            comm = op_analysis.FakeComm(
                group, self.mesh.axis_index(rank, PARTY_AXIS),
                counter.collectives, rank=rank, device=dev)
            xb = torch.zeros((1, n, fp), dtype=torch.uint8, device=dev)
            feat_gid = torch.zeros((1, fp), dtype=torch.int32, device=dev)
            feat_sel = torch.zeros((t, m * fp), dtype=torch.bool, device=dev)
            weights = torch.zeros((t, n), dtype=torch.float32, device=dev)
            y_stats = torch.zeros((n, p.n_stat_channels),
                                  dtype=torch.float32, device=dev)
            counter.track(xb, feat_gid, feat_sel, weights, y_stats)
            with counter:
                xb_f = tree.fold_parties(xb)
                trees = [tree.build_tree(xb_f, feat_gid, feat_sel[i],
                                         weights[i], y_stats, p,
                                         hist_impl=self.hist_impl, comm=comm)
                         for i in range(t)]
                trees = PartyTree(*(torch.stack([f[0] for f in fs_])
                                    for fs_ in zip(*trees)))
            if fs.n_test:
                trees = PartyTree(*(f[None] for f in trees))
                xbt = torch.zeros((1, fs.n_test, fp), dtype=torch.uint8,
                                  device=dev)
                kw = dict(self.predict_kw)
                idx = None
                if kw.pop("compact", False):
                    idx = torch.zeros((t, 2 ** p.max_depth),
                                      dtype=torch.int32, device=dev)
                counter = op_analysis.OpCounter()
                counter.track(trees, xbt, idx)
                with counter:
                    prediction.forest_predict_oneround(
                        trees, xbt, p, aggregate=False, leaf_idx=idx,
                        comm=op_analysis.FakeComm(
                            group, self.mesh.axis_index(rank, PARTY_AXIS),
                            counter.collectives, rank=rank, device=dev),
                        **kw)
        return RankRun(rank, _counts(counter), 0)

    def analyze(self) -> dict[str, Any]:
        """Every rank runs the same program on the same shapes: rank 0's
        record."""
        return _record(self.run(0), 0.0, self.mesh.size)


def forest_case(shape_name: str, mesh: RankMesh, params=None, *,
                hist_impl: str = "cuda", **predict_kw) -> ForestCase:
    """The federated-forest case on the (trees, parties) ``mesh``, the
    JAX package's arguments: ``params`` (by default classification, 2
    classes, ``n_trees_per_shard`` trees, depth 8, 32 bins), the histogram
    route ``hist_impl`` (the kernel's, ``"cuda"``: what a card's tensors
    take), and for ``ff_predict`` the predict knobs ``compact``,
    ``mask_dtype``, ``vote_impl``."""
    from repro_torch.core.types import ForestParams
    fs = FOREST_SHAPES[shape_name]
    p = params or ForestParams(task="classification", n_classes=2,
                               n_estimators=fs.n_trees_per_shard, max_depth=8,
                               n_bins=32)
    return ForestCase(fs, mesh, p, hist_impl, predict_kw)
