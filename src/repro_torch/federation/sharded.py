"""The sharded substrate's ranks: one process per mesh position, rank to rank.

The JAX package's sharded substrate runs the protocol under ``shard_map``
over a device mesh whose "parties" axis is the protocol axis.  The port's
counterpart is a ``torch.distributed`` world (launch/mesh.py::RankMesh):

  * **the ranks** are the party-per-process substrate's workers
    (federation/party_worker.py), spawned by the same
    :class:`~repro_torch.federation.distributed.Coordinator` — the same
    ``spawn`` context, one device per child, the histogram library built
    before the spawn — which then join one process group (``dist_init``).
    Rank ``r`` of a ``(T, P)`` mesh is party ``r % P`` of tree shard
    ``r // P``;
  * **the collectives** go rank to rank over each tree shard's "parties"
    subgroup (:class:`DistComm`), never through the session: the session
    only ships a run's arguments and collects its results;
  * **the bodies** are the distributed substrate's protocol bodies
    (``distributed.DIST_PROGRAMS``: forest fit — ``hist_subtraction``
    included, which a party process refuses — F-LR predict, the toy) plus
    rank-only ones registered here (:data:`RANK_PROGRAMS`): the forest's
    per-tree one-round and classical predicts, boosting predict, F-LR fit,
    and ``call`` — any
    module-level function ``fn(*party_args, *shared_args, comm=None)``
    written over a leading party dimension (the port's convention: M under
    the simulated substrate, 1 on a rank).

Bit identity with the simulated substrate is the contract:

  * ``all_gather`` moves bytes: every payload is gathered as its ``uint8``
    view, so floats (``-0.0`` and NaN payloads too) arrive bit for bit;
  * ``psum`` is that gather followed by a sum over the party dimension on
    the rank's device — the very ``sum(0)`` the simulated substrate runs
    over its stacked parties.  Never a library ``all_reduce``, whose order
    is its own;
  * gloo and card tensors: the comm stages each collective of a card
    tensor through host buffers explicitly, and counts the staged bytes
    (``sharded.staged_bytes``).  The compute stays on the card.

Each rank counts its collective rounds, bytes sent and received, and
staged bytes in its telemetry registry (``sharded.*``), which reaches the
session through ``ShardedSubstrate.collect_telemetry`` under ``rank<r>.``.

The same ranks serve an LM sharded over a ``("data", "model")`` mesh
(models/parallel.py): there a rank's :class:`DistComm` runs over its model
axis's group (its "parties" are the model shards), ``comm.axes["data"]``
over its data axis's, and the rank program ``lm`` runs the model, served
or trained.  Its tensor-parallel and data-parallel sums are the library's
``all_reduce`` (:meth:`DistComm.all_reduce`) and ``reduce_scatter``
(:meth:`DistComm.reduce_scatter`, a training step's FSDP gradients),
which the forest never uses.
"""
from __future__ import annotations

import dataclasses
import importlib
import os
import socket
from datetime import timedelta
from typing import Callable

import numpy as np
import torch

from repro_torch.core import fedlinear, prediction
from repro_torch.core.tree import PartyTree
from repro_torch.core.types import TREE_AXIS, ForestParams
from repro_torch.federation.distributed import (_MASK_DTYPES, _DistCallable,
                                                host, on_device)
from repro_torch.federation.transport import TransportError
from repro_torch.observability import registry as telemetry
from repro_torch.observability import trace as tracing


# ------------------------------------------------------------------ rank comm
class DistComm:
    """A rank's collective endpoint over its tree shard's "parties" group.

    The interface of ``distributed.Comm`` (``all_gather`` / ``psum`` over
    tensors or NumPy arrays, ``party_index``, ``n_parties``, ``device``),
    which ``core/tree.py::build_tree(comm=)`` and the protocol bodies take.
    Several arrays in one call share one collective round."""

    def __init__(self, group, rank: int, party_index: int, n_parties: int,
                 device: torch.device, backend: str):
        self.group = group
        self.rank = int(rank)
        self.party_index = int(party_index)
        self.n_parties = int(n_parties)
        self.device = torch.device(device)
        self.backend = backend
        self.axes: dict[str, "DistComm"] = {}   # the other axes' comms
        self.mesh = None                         # the world's RankMesh
        self.held: dict = {}     # what a rank program keeps between runs
        self._seq = 0
        reg = telemetry.REGISTRY
        self._m_rounds = reg.counter("sharded.rounds")
        self._m_sent = reg.counter("sharded.bytes_sent")
        self._m_received = reg.counter("sharded.bytes_received")
        self._m_staged = reg.counter("sharded.staged_bytes")

    def _round(self, kind: str, arrays) -> list:
        import torch.distributed as dist
        ts = [a if torch.is_tensor(a) else torch.as_tensor(np.asarray(a))
              for a in arrays]
        flat = [t.detach().contiguous().reshape(-1).view(torch.uint8)
                for t in ts]
        buf = torch.cat(flat) if len(flat) > 1 else flat[0]
        m = self.n_parties
        with tracing.TRACER.span(f"coll.{kind}", category="comm",
                                 seq=self._seq, bytes=int(buf.numel())):
            if buf.numel() == 0:
                stack = buf.new_zeros((m, 0))
            else:
                staged = self.backend == "gloo" and buf.is_cuda
                send = buf.cpu() if staged else buf
                recv = [torch.empty_like(send) for _ in range(m)]
                dist.all_gather(recv, send, group=self.group)
                stack = torch.stack(recv)
                if staged:
                    stack = stack.to(buf.device)
                    self._m_staged.inc(send.numel() + stack.numel())
                self._m_sent.inc(send.numel())
                self._m_received.inc(stack.numel())
        self._m_rounds.inc()
        self._seq += 1
        out, off = [], 0
        for a, t, f in zip(arrays, ts, flat):
            part = stack[:, off:off + f.numel()].contiguous()
            off += f.numel()
            part = part.view(t.dtype).reshape((m,) + tuple(t.shape))
            if kind == "psum":
                part = part.sum(0, dtype=t.dtype)
            out.append(part if torch.is_tensor(a) else part.cpu().numpy())
        return out

    def all_gather(self, *arrays):
        """Stacked (M, ...) payloads in party order, bit for bit."""
        out = self._round("gather", arrays)
        return out[0] if len(arrays) == 1 else out

    def psum(self, *arrays):
        """Dtype-preserving sum over parties: the gathered stack summed over
        its party dimension, as the simulated substrate sums."""
        out = self._round("psum", arrays)
        return out[0] if len(arrays) == 1 else out

    def all_gather_cat(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The group's tensors concatenated along ``dim`` in group order,
        bit for bit; ``t`` itself in a group of one."""
        if self.n_parties == 1:
            return t
        return torch.cat(self.all_gather(t).unbind(0), dim)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The group's sum of ``t`` by the library's ``all_reduce`` (the
        LM's tensor-parallel sum: every rank receives the same bits, in a
        float order of the library's own), in a new tensor: ``t`` is left
        as it was (autograd and selective remat may hold it); ``t`` itself
        in a group of one.  A card tensor on gloo is staged through a host
        buffer, and counted."""
        if self.n_parties == 1:
            return t
        import torch.distributed as dist
        nbytes = t.numel() * t.element_size()
        with tracing.TRACER.span("coll.all_reduce", category="comm",
                                 seq=self._seq, bytes=int(nbytes)):
            buf = self._staged(t)
            dist.all_reduce(buf, group=self.group)
            buf = self._unstaged(buf, t, nbytes)
            self._m_sent.inc(nbytes)
            self._m_received.inc(nbytes)
        self._m_rounds.inc()
        self._seq += 1
        return buf

    def reduce_scatter(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's chunk, along ``dim``, of the group's sum of ``t``
        (``dim`` must split into the group's size): the library's
        ``reduce_scatter_tensor`` on NCCL, an ``all_reduce`` and the
        rank's chunk of it on gloo (the same sum; gloo's reduce-scatter is
        not in every release the port meets).  ``t`` itself in a group of
        one.  A card tensor on gloo is staged through a host buffer, and
        counted."""
        m = self.n_parties
        if m == 1:
            return t
        import torch.distributed as dist
        if t.shape[dim] % m:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                             f"over {m} ranks")
        front = t.movedim(dim, 0)
        nbytes = t.numel() * t.element_size()
        with tracing.TRACER.span("coll.reduce_scatter", category="comm",
                                 seq=self._seq, bytes=int(nbytes)):
            if self.backend == "nccl":
                src = front.contiguous()
                out = src.new_empty((src.shape[0] // m, *src.shape[1:]))
                dist.reduce_scatter_tensor(out, src, group=self.group)
                self._m_received.inc(nbytes // m)
            else:
                buf = self._staged(front)
                dist.all_reduce(buf, group=self.group)
                out = self._unstaged(
                    buf.chunk(m, 0)[self.party_index].clone(), t, nbytes)
                self._m_received.inc(nbytes)
            self._m_sent.inc(nbytes)
        self._m_rounds.inc()
        self._seq += 1
        return out.movedim(0, dim).contiguous()

    def _staged(self, t: torch.Tensor) -> torch.Tensor:
        """A contiguous copy of ``t`` for an in-place collective: on the
        host for a card tensor on gloo."""
        if self.backend == "gloo" and t.is_cuda:
            return t.to("cpu", memory_format=torch.contiguous_format)
        return torch.clone(t, memory_format=torch.contiguous_format)

    def _unstaged(self, buf: torch.Tensor, like: torch.Tensor,
                  nbytes: int) -> torch.Tensor:
        """``buf`` back on ``like``'s device, the host bytes counted."""
        if buf.device == like.device:
            return buf
        self._m_staged.inc(nbytes + buf.numel() * buf.element_size())
        return buf.to(like.device)


def join_world(msg: dict, device: torch.device) -> DistComm:
    """Worker side of ``dist_init``: join the process group, create the
    groups of the mesh's inner axis (every tree shard's parties, or every
    data shard's model ranks) — and, on an LM mesh, of its data axis — and
    return this rank's comm over its inner-axis group (the data axis's
    under ``axes["data"]``)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import DATA_AXIS, RankMesh, axis_groups
    # every rank is a process on this host: rendezvous over loopback
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    mesh = RankMesh(tuple(msg["axes"]), tuple(msg["shape"]),
                    tuple(msg["devices"]), msg["backend"])
    rank = int(msg["rank"])
    dist.init_process_group(mesh.backend, init_method=msg["init_method"],
                            world_size=mesh.size, rank=rank,
                            timeout=timedelta(seconds=float(msg["timeout"])))
    inner = mesh.axis_names[-1]
    names = (inner, DATA_AXIS) if DATA_AXIS in mesh.axis_names else (inner,)
    groups = axis_groups(mesh, rank, names)
    comm = DistComm(groups[inner], rank, mesh.axis_index(rank, inner),
                    mesh.axis_size(inner), device, mesh.backend)
    for name in names[1:]:
        comm.axes[name] = DistComm(groups[name], rank,
                                   mesh.axis_index(rank, name),
                                   mesh.axis_size(name), device,
                                   mesh.backend)
    comm.mesh = mesh
    return comm


def leave_world() -> None:
    """Tear this process's process group down, if it joined one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def start_ranks(coord, mesh, timeout: float) -> None:
    """Session side: have the coordinator's started workers join one
    ``torch.distributed`` world laid out as ``mesh``."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    msg = {"op": "dist_init", "backend": mesh.backend,
           "init_method": f"tcp://127.0.0.1:{port}",
           "axes": list(mesh.axis_names), "shape": list(mesh.shape),
           "devices": list(mesh.devices), "timeout": float(timeout)}
    coord.request_many({r: dict(msg, rank=r) for r in range(mesh.size)},
                       timeout=coord.connect_timeout + timeout)


# ------------------------------------------------------------ rank programs
RANK_PROGRAMS: dict[str, Callable] = {}


def register_rank_program(name: str):
    """Register a rank-only protocol body: body(comm, payload, *args)."""
    def deco(fn):
        RANK_PROGRAMS[name] = fn
        return fn
    return deco


def _import_ref(ref: str):
    module, _, qualname = ref.partition(":")
    obj = importlib.import_module(module)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


def call_spec(fn: Callable, n_party: int) -> dict:
    """The ``call`` spec of a module-level function, which every rank
    imports by name; anything else (a closure, a lambda) has no rank
    body."""
    ref = f"{getattr(fn, '__module__', '')}:{getattr(fn, '__qualname__', '')}"
    try:
        ok = _import_ref(ref) is fn
    except (ImportError, AttributeError, ValueError):
        ok = False
    if not ok:
        raise NotImplementedError(
            f"{getattr(fn, '__name__', fn)!r} has no rank body: the sharded "
            f"substrate runs the registered protocol bodies and module-level "
            f"functions fn(*party_args, *shared_args, comm=None)")
    return {"name": "call", "payload": {"fn": ref, "n_party": int(n_party)},
            "bound": ()}


@register_rank_program("lm")
def _lm_body(comm: DistComm, payload, *args):
    """An LM sharded over the rank's ("data", "model") mesh: build it, run
    its prefill, decode and serving waves (models/parallel.py)."""
    from repro_torch.models import parallel
    return parallel.rank_op(comm, payload, *args)


@register_rank_program("call")
def _call_body(comm: DistComm, payload, *args):
    """A module-level protocol function on this rank's party: party args
    get their leading party dimension back (1), every argument becomes a
    tensor on the rank's device, and the collectives go through ``comm``."""
    fn = _import_ref(payload["fn"])
    n_party = int(payload["n_party"])
    args = [on_device(a, comm.device) for a in args]
    party = [PartyTree(*(f[None] for f in a)) if isinstance(a, PartyTree)
             else a[None] for a in args[:n_party]]
    return host(fn(*party, *args[n_party:], comm=comm))


def forest_predict_trees_spec(params: ForestParams, *, compact: bool,
                              mask_dtype: torch.dtype, vote_impl: str):
    return {"name": "forest_predict_trees",
            "payload": {"params": dataclasses.asdict(params),
                        "compact": bool(compact),
                        "mask_dtype": _MASK_DTYPES[mask_dtype],
                        "vote_impl": vote_impl},
            "bound": (0, 2)}


@register_rank_program("forest_predict_trees")
def _forest_predict_trees_body(comm: DistComm, payload, trees, xbt,
                               leaf_idx=None):
    """The one-round protocol over this tree shard's trees, per tree
    (``aggregate=False``): the forest vote runs in the session, over every
    shard's trees."""
    params = ForestParams(**payload["params"])
    dev = comm.device
    trees = PartyTree(*(f[None] for f in on_device(trees, dev)))
    idx = on_device(leaf_idx, dev) if payload.get("compact") else None
    return host(prediction.forest_predict_oneround(
        trees, on_device(xbt, dev)[None], params, aggregate=False,
        mask_dtype=getattr(torch, payload["mask_dtype"]),
        vote_impl=payload.get("vote_impl", "einsum"), leaf_idx=idx,
        comm=comm))


def forest_predict_classical_spec(params: ForestParams):
    return {"name": "forest_predict_classical",
            "payload": {"params": dataclasses.asdict(params)},
            "bound": (0,)}


@register_rank_program("forest_predict_classical")
def _forest_predict_classical_body(comm: DistComm, payload, trees, xbt):
    """The multi-round baseline over this tree shard's trees, per tree: one
    party sum per level through ``comm``; the forest vote runs in the
    session, as for the one-round protocol."""
    params = ForestParams(**payload["params"])
    dev = comm.device
    trees = PartyTree(*(f[None] for f in on_device(trees, dev)))
    return host(prediction.forest_predict_classical(
        trees, on_device(xbt, dev)[None], params, aggregate=False,
        comm=comm))


def boosting_predict_spec(params, *, compact: bool, mask_dtype: torch.dtype):
    return {"name": "boosting_predict",
            "payload": {"params": dataclasses.asdict(params.tree_params()),
                        "learning_rate": float(params.learning_rate),
                        "task": params.task, "compact": bool(compact),
                        "mask_dtype": _MASK_DTYPES[mask_dtype]},
            "bound": (0, 2, 3)}


@register_rank_program("boosting_predict")
def _boosting_predict_body(comm: DistComm, payload, trees, xbt, base,
                           leaf_idx=None):
    """One-wave boosting prediction: the per-round one-round protocol (one
    party sum for every round) and ``base + lr * Σ rounds``, as
    ``programs.boosting_predict_program`` computes it in process."""
    tp = ForestParams(**payload["params"])
    dev = comm.device
    trees = PartyTree(*(f[None] for f in on_device(trees, dev)))
    idx = on_device(leaf_idx, dev) if payload.get("compact") else None
    per_round = prediction.forest_predict_oneround(
        trees, on_device(xbt, dev)[None], tp, aggregate=False,
        mask_dtype=getattr(torch, payload["mask_dtype"]), leaf_idx=idx,
        comm=comm)
    f = on_device(base, dev) + payload["learning_rate"] * per_round.sum(0)
    if payload["task"] == "binary":
        return host((f > 0).to(torch.int32))
    return host(f)


def linear_fit_spec(task: str, lr: float, steps: int, l2: float) -> dict:
    return {"name": "linear_fit",
            "payload": {"task": task, "lr": float(lr), "steps": int(steps),
                        "l2": float(l2)},
            "bound": ()}


@register_rank_program("linear_fit")
def _linear_fit_body(comm: DistComm, payload, x_i, y):
    """F-LR training on this rank's feature block: one party sum of the
    block logits per step, gradients local."""
    dev = comm.device
    w, b = fedlinear._spmd_fit(
        on_device(x_i, dev).to(torch.float32)[None], on_device(y, dev),
        task=payload["task"], lr=payload["lr"], steps=payload["steps"],
        l2=payload["l2"], comm=comm)
    return [host(w[0]), host(b[0])]


# ------------------------------------------------------------ session side
def _stack(outs: list):
    """Stack per-party results on a new leading party axis (NamedTuples
    field by field, lists element by element)."""
    first = outs[0]
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_stack([o[i] for o in outs])
                             for i in range(len(first))))
    if isinstance(first, (list, tuple)):
        return [_stack([o[i] for o in outs]) for i in range(len(first))]
    return np.stack([np.asarray(o) for o in outs])


def _concat(shards: list, axis: int):
    first = shards[0]
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_concat([s[i] for s in shards], axis)
                             for i in range(len(first))))
    if isinstance(first, list):
        return [_concat([s[i] for s in shards], axis)
                for i in range(len(first))]
    return np.concatenate(shards, axis=axis)


def _shard(a, t: int, n: int):
    """Tree shard ``t`` of ``n`` along the leading dimension."""
    if isinstance(a, tuple) and hasattr(a, "_fields"):
        return type(a)(*(_shard(x, t, n) for x in a))
    size = a.shape[0]
    if size % n:
        raise ValueError(f"{size} trees do not split over a 'trees' axis of "
                         f"{n}")
    k = size // n
    return a[t * k:(t + 1) * k]


class RankCallable(_DistCallable):
    """A protocol program bound to a sharded substrate's ranks.

    The calling convention of every substrate: the first ``n_party`` args
    carry the leading (M, ...) party dimension, the rest are shared.  Rank
    ``(t, p)`` receives party ``p``'s slice of each party argument, and
    tree shard ``t`` of every argument placed on the "trees" axis
    (``party_specs`` / ``shared_specs``; a party argument's tree dimension
    follows its party dimension).  The output is the per-party stack of
    each tree shard, concatenated along the tree dimension when
    ``out_specs`` places it on "trees", else shard 0's."""

    def __init__(self, substrate, spec: dict, n_party: int, n_shared: int,
                 party_specs=None, shared_specs=None, out_specs=None):
        super().__init__(substrate, spec, n_party, n_shared,
                         active=range(substrate.mesh.size))
        self.party_specs = self._specs(party_specs, n_party, "party")
        self.shared_specs = self._specs(shared_specs, n_shared, "shared")
        if out_specs not in (None, TREE_AXIS):
            raise ValueError(f"out_specs must be None or {TREE_AXIS!r}, got "
                             f"{out_specs!r}")
        self.out_specs = out_specs

    @staticmethod
    def _specs(specs, n: int, what: str) -> tuple:
        specs = (None,) * n if specs is None else tuple(specs)
        if len(specs) != n:
            raise ValueError(f"{n} {what} args, {len(specs)} specs")
        bad = [s for s in specs if s not in (None, TREE_AXIS)]
        if bad:
            raise ValueError(f"a placement is None (replicated) or "
                             f"{TREE_AXIS!r}, got {bad}")
        return specs

    def _copy(self) -> "RankCallable":
        return RankCallable(self.substrate, self.spec, self.n_party,
                            self.n_shared, self.party_specs,
                            self.shared_specs, self.out_specs)

    def _wire(self, k: int, a, rank: int):
        if a is None:
            return None
        mesh = self.substrate.mesh
        t, p = mesh.coords(rank)
        if k < self.n_party:
            a, spec = self._slot(a, p), self.party_specs[k]
        else:
            spec = self.shared_specs[k - self.n_party]
        if spec == TREE_AXIS and mesh.n_tree_shards > 1:
            a = _shard(a, t, mesh.n_tree_shards)
        return a

    def _run_fields(self, rank: int, active) -> dict:
        return {"comm": "ranks",
                "party_index": self.substrate.mesh.coords(rank)[1],
                "n_parties": self.substrate.mesh.n_parties}

    def _assemble(self, outs: dict, active):
        mesh = self.substrate.mesh
        n_p = mesh.n_parties
        per_shard = [_stack([outs[t * n_p + p] for p in range(n_p)])
                     for t in range(mesh.n_tree_shards)]
        if self.out_specs == TREE_AXIS and len(per_shard) > 1:
            return _concat(per_shard, axis=1)
        return per_shard[0]

    def __call__(self, *args):
        try:
            return super().__call__(*args)
        except (RuntimeError, TransportError):
            # a failed run leaves the other ranks inside a collective: the
            # world is torn down, and the next program call starts a new one
            self.substrate.shutdown()
            raise


class Reduced:
    """A rank program followed by a reduction in the session — the forest
    vote over every tree shard's per-tree outputs.  ``bind`` binds the rank
    program (the serving engine's per-bucket seam)."""

    def __init__(self, inner: RankCallable, reduce: Callable):
        self.inner = inner
        self.reduce = reduce

    def bind(self, *args) -> "Reduced":
        return Reduced(self.inner.bind(*args), self.reduce)

    def __call__(self, *args):
        return self.reduce(self.inner(*args))


def forest_vote(per_tree, params: ForestParams, device: torch.device):
    """The forest's aggregate over party 0's (T, N) per-tree outputs, on
    the session's device, by the simulated substrate's own code
    (``prediction.forest_vote``)."""
    return prediction.forest_vote(
        torch.as_tensor(np.asarray(per_tree)[0], device=device), params)

