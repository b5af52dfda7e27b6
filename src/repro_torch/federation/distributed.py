"""Party-per-process federation: the transport-backed DistributedSubstrate.

Each party is its own OS process (federation/party_worker.py) holding its
own data on its own device; a coordinator in the session process drives the
protocol over framed msgpack sockets (federation/transport.py):

  * **fit** — ``core/tree.py::build_tree`` itself, run in every party's
    process over that party's columns alone (a leading party dimension of
    1): the same histogram kernel, split gains and local argbest as in
    process; the level's bests are gathered over the wire, every party runs
    the paper's master reduce (``tree.reduce_level``) on the gathered
    stack, and one sum over the parties broadcasts the owner-computed
    partition bits.  The routing state is integer, so the built PartyTree
    is the simulated substrate's, bit for bit.
  * **predict/serve** — the one-round masked-leaf collective (Prop. 1): each
    party computes its leaf-membership masks (``prediction.party_masks``),
    a single sum intersects them, and every party votes locally.
  * **ingest** — the hashed-ID alignment handshake of
    ``partition_from_blocks`` over the same channel: workers load their own
    blocks, ship salted SHA-256 hashes only, the coordinator intersects
    them, and parties bin locally.  Raw sample IDs and raw features never
    leave a party; only hashed IDs, binned values, and masked statistics
    cross the wire.

Fault tolerance rides on transport primitives: per-round-trip timeout
budgets (PartyTimeout), retry with jittered exponential backoff
(RetryPolicy), a per-party circuit breaker (CircuitOpenError after K
consecutive failures), health-check pings, and an injectable chaos hook
(drop/delay/kill one party's next run) that the fault tests use to prove
each behavior deterministically.  Serving degradation — answering from the
trees whose split paths avoid a dead party — is :func:`surviving_trees`
plus a predict program scoped to the live parties (serving/engine.py).

Collective semantics match the in-process substrate exactly: gathers stack
party payloads in ascending party order (the stacked party dimension);
sums use ``np.add.reduce(stack, axis=0, dtype=payload.dtype)``, which keeps
the payload dtype (a uint8 membership mask stays uint8).  Operands cross
the wire as host arrays and become tensors on the worker's device there;
results come back as host arrays.

Workers start from a ``spawn`` context (a forked child cannot use its
parent's CUDA context).  On the card the coordinator builds the histogram
kernel before it spawns them, so the M workers load one build instead of
racing M compilers.
"""
from __future__ import annotations

import contextlib
import dataclasses
import multiprocessing
import os
import socket
import time
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.analysis import runtime as egress_runtime
from repro_torch.core import crypto, prediction, tree
from repro_torch.core.party import VerticalPartition, _pad_groups
from repro_torch.core.partyblock import (CSVSource, DataSource, PartyBlock,
                                         feature_groups)
from repro_torch.core.tree import PartyTree
from repro_torch.core.types import ForestParams
from repro_torch.device import resolve_device
from repro_torch.federation import transport
from repro_torch.federation.transport import (CircuitBreaker, PartyDead,
                                              PartyTimeout,
                                              PartyUnavailableError,
                                              ProtocolError, RetryPolicy)
from repro_torch.observability import registry as telemetry
from repro_torch.observability import trace as tracing

transport.register_namedtuple(PartyTree)

#: the wire names of the mask dtypes (NumPy's, as the JAX package sends them)
_MASK_DTYPES = {torch.uint8: "uint8", torch.int32: "int32"}


class RunAborted(Exception):
    """Coordinator superseded this run (timeout elsewhere, retry incoming)."""


# ------------------------------------------------------------- host / device
def host(a):
    """``a`` as host NumPy, NamedTuples / lists walked field by field."""
    if a is None:
        return None
    if torch.is_tensor(a):
        return a.detach().cpu().numpy()
    if isinstance(a, tuple) and hasattr(a, "_fields"):
        return type(a)(*(host(x) for x in a))
    if isinstance(a, (list, tuple)):
        return type(a)(host(x) for x in a)
    return np.asarray(a)


def on_device(a, device: torch.device):
    """``a`` as tensors on ``device``, NamedTuples / lists walked."""
    if a is None:
        return None
    if isinstance(a, tuple) and hasattr(a, "_fields"):
        return type(a)(*(on_device(x, device) for x in a))
    if isinstance(a, (list, tuple)):
        return type(a)(on_device(x, device) for x in a)
    if torch.is_tensor(a):
        return a.to(device)
    return torch.as_tensor(np.asarray(a), device=device)


def _stack(outs: list):
    """Stack per-party results on a new leading party axis (NamedTuples
    field by field)."""
    first = outs[0]
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_stack([o[i] for o in outs])
                             for i in range(len(first))))
    return np.stack([np.asarray(o) for o in outs])


# ------------------------------------------------------------------ worker comm
class Comm:
    """Worker-side collective endpoint for one run.

    The distributed twin of the in-process party dimension: ``all_gather``
    / ``psum`` send one ``coll`` message and block for the coordinator's
    combined ``coll_result``.  Tensors go out as host arrays and come back
    as tensors on the device they came from; NumPy stays NumPy.  Messages
    from superseded runs are skipped; an ``abort`` for the current run
    raises :class:`RunAborted`."""

    def __init__(self, channel, run_id, party_index: int, n_parties: int,
                 device: torch.device | str = "cpu"):
        self.channel = channel
        self.run_id = run_id
        self.party_index = int(party_index)
        self.n_parties = int(n_parties)
        self.device = torch.device(device)
        self._seq = 0

    def _round(self, kind: str, arrays) -> list:
        like = next((a for a in arrays if torch.is_tensor(a)), None)
        arrays = [host(a) for a in arrays]
        with tracing.TRACER.span(f"coll.{kind}", category="comm",
                                 seq=self._seq):
            out = self._round_inner(kind, arrays)
        if like is not None:
            out = [torch.as_tensor(o, device=like.device) for o in out]
        return out

    def _round_inner(self, kind: str, arrays) -> list:
        self.channel.send({"op": "coll", "run": self.run_id,
                           "seq": self._seq, "kind": kind, "data": arrays})
        while True:
            msg = self.channel.recv(None)
            op = msg.get("op")
            if op in ("shutdown",):
                raise RunAborted
            if op == "abort":
                if msg.get("run") == self.run_id:
                    raise RunAborted
                continue
            if msg.get("run") != self.run_id:
                continue                      # superseded-run stragglers
            if op != "coll_result" or msg.get("seq") != self._seq:
                raise ProtocolError(
                    f"expected coll_result seq {self._seq}, got "
                    f"{op} seq {msg.get('seq')}")
            self._seq += 1
            return msg["data"]

    def all_gather(self, *arrays):
        """Stacked (M, ...) payloads in party order."""
        out = self._round("gather", arrays)
        return out[0] if len(arrays) == 1 else out

    def psum(self, *arrays):
        """Dtype-preserving sum over parties."""
        out = self._round("psum", arrays)
        return out[0] if len(arrays) == 1 else out


# ------------------------------------------------------------- program registry
DIST_PROGRAMS: dict[str, Callable] = {}


def register_program(name: str):
    """Register a worker-side protocol body: body(comm, payload, *args)."""
    def deco(fn):
        DIST_PROGRAMS[name] = fn
        return fn
    return deco


# --------------------------------------------------------- forest fit protocol
@register_program("forest_fit")
def _forest_fit_body(comm: Comm, payload, xb, feat_gid, feat_sels, weights,
                     y_stats):
    """Per-party fit body: ``build_tree`` over this party's (N, Fp) columns
    for each bagging round, fields stacked over the trees.

    A party process refuses ``hist_subtraction``, as the JAX package's
    does; a sharded substrate's rank (a ``DistComm``, not a :class:`Comm`)
    runs it, since ``build_tree`` keeps the parent histograms on the rank."""
    params = ForestParams(**payload["params"])
    if params.hist_subtraction and isinstance(comm, Comm):
        raise NotImplementedError(
            "hist_subtraction threads parent histograms through the level "
            "loop — in-process substrates and sharded ranks only")
    hist_impl = payload.get("hist_impl") or params.hist_impl
    dev = comm.device
    xb_f = tree.fold_parties(on_device(xb, dev)[None])     # (N, Fp), M = 1
    feat_gid = on_device(feat_gid, dev).to(torch.int32)[None]
    feat_sels = on_device(feat_sels, dev).to(torch.bool)
    weights = on_device(weights, dev).to(torch.float32)
    y_stats = on_device(y_stats, dev).to(torch.float32)
    trees_out = []
    for t in range(feat_sels.shape[0]):
        with tracing.TRACER.span("fit.tree", category="compute", tree=t):
            tr = tree.build_tree(xb_f, feat_gid, feat_sels[t], weights[t],
                                 y_stats, params, hist_impl=hist_impl,
                                 comm=comm, tree=t)
        trees_out.append(PartyTree(*(f[0] for f in tr)))
    return PartyTree(*(host(torch.stack(fs)) for fs in zip(*trees_out)))


# ----------------------------------------------------- forest predict protocol
@register_program("forest_predict")
def _forest_predict_body(comm: Comm, payload, trees, xbt, leaf_idx=None):
    """The one-round protocol: local membership, ONE psum, local vote."""
    params = ForestParams(**payload["params"])
    mask_dtype = getattr(torch, payload.get("mask_dtype") or "int32")
    vote_impl = payload.get("vote_impl", "einsum")
    dev = comm.device
    trees = PartyTree(*(f[None] for f in on_device(trees, dev)))
    xbt = on_device(xbt, dev)[None]
    idx = (on_device(leaf_idx, dev)
           if payload.get("compact") and leaf_idx is not None else None)
    mem, leaf = prediction.party_masks(trees, xbt, params, mask_dtype, idx)
    m = comm.psum(mem[0])
    inter = m == comm.n_parties                     # Prop. 1 intersection
    return host(prediction._combine_votes(inter, leaf, params, True,
                                          vote_impl))


# ------------------------------------------------------- linear / toy protocol
@register_program("linear_predict")
def _linear_predict_body(comm: Comm, payload, x_i, w_i, b):
    """F-LR joint logit: z = psum_i(X_i w_i) + b, thresholded per task."""
    dev = comm.device
    x = on_device(x_i, dev).to(torch.float32)
    w = on_device(w_i, dev).to(torch.float32)
    prediction._check_full_f32(dev, "F-LR")
    z_loc = torch.matmul(x[None], w[None, :, None])[0, :, 0]
    z = comm.psum(z_loc) + on_device(b, dev).to(torch.float32).reshape(())
    if payload["task"] == "classification":
        return host((z > 0).to(torch.int32))
    return host(z)


@register_program("toy_affine")
def _toy_affine_body(comm: Comm, payload, x, scale):
    """Conformance-suite protocol: exercises both collectives in int32."""
    x = np.asarray(x)
    g = comm.all_gather(x)
    s = comm.psum((x * scale).astype(x.dtype))
    return (g.sum(0, dtype=x.dtype) + s
            + np.asarray(comm.party_index, x.dtype))


def toy_affine_fn(x, scale):
    """The in-process twin of the toy protocol, over the stacked party
    dimension — the conformance suite asserts bit-identity of the two on
    every registered substrate."""
    x = torch.as_tensor(np.asarray(x))
    s = (x * int(scale)).to(x.dtype).sum(0, dtype=x.dtype)
    idx = torch.arange(x.shape[0], dtype=x.dtype).reshape(
        (-1,) + (1,) * (x.dim() - 1))
    return x.sum(0, dtype=x.dtype)[None] + s[None] + idx


# ------------------------------------------------------------ protocol specs
def forest_fit_spec(params: ForestParams, hist_impl: str | None = None):
    return {"name": "forest_fit",
            "payload": {"params": dataclasses.asdict(params),
                        "hist_impl": hist_impl},
            "bound": ()}


def forest_predict_spec(params: ForestParams, *, compact=False,
                        mask_dtype: torch.dtype = torch.int32,
                        vote_impl="einsum"):
    # bound argnums: trees (0, party arg) and leaf_idx (2, shared) are the
    # model-side operands the serving engine ships once per executable.
    return {"name": "forest_predict",
            "payload": {"params": dataclasses.asdict(params),
                        "compact": bool(compact),
                        "mask_dtype": _MASK_DTYPES[mask_dtype],
                        "vote_impl": vote_impl},
            "bound": (0, 2)}


def linear_predict_spec(task: str):
    return {"name": "linear_predict", "payload": {"task": task},
            "bound": (1, 2)}


def toy_affine_spec():
    return {"name": "toy_affine", "payload": {}, "bound": ()}


# ---------------------------------------------------------- degraded serving
def surviving_trees(trees, dead_parties) -> np.ndarray:
    """Indices of trees whose split paths avoid every dead party's features.

    A tree where a dead party owns no splits descends both branches at that
    party's (nonexistent) nodes, so its membership mask over the surviving
    parties intersects to exactly the full-federation leaf assignment —
    predictions from these trees are exact, not approximate."""
    owner = host(trees.owner)
    if owner.ndim == 3:                       # (M, T, nn) party stack
        owner = owner[0]                      # owner is the shared master view
    dead = np.asarray(sorted(set(int(p) for p in dead_parties)))
    if dead.size == 0:
        return np.arange(owner.shape[0])
    hit = np.isin(owner, dead) & (owner >= 0)
    return np.flatnonzero(~hit.any(axis=1))


# ------------------------------------------------------------------ coordinator
def _worker_entry(host_addr, port, index, src_root, device):
    import sys
    if src_root and src_root not in sys.path:
        sys.path.insert(0, src_root)
    from repro_torch.federation.party_worker import worker_main
    worker_main(host_addr, port, index, device)


class Coordinator:
    """The session side: spawns one worker process per party on
    ``device`` (or worker ``i`` on ``devices[i]``), relays the
    collectives, and owns the fault-tolerance state (retry policy, breaker,
    dead-party set).  The sharded substrate starts its ranks through it too
    (federation/sharded.py): there the workers talk to each other directly
    and it relays nothing."""

    def __init__(self, parties: int, *, device: torch.device | str = "cpu",
                 devices=None, host: str = "127.0.0.1",
                 round_timeout: float = 120.0, connect_timeout: float = 30.0,
                 retry: RetryPolicy | None = None, breaker_threshold: int = 3):
        self.n_parties = int(parties)
        self.device = torch.device(device)
        self.devices = (tuple(str(torch.device(d)) for d in devices)
                        if devices is not None
                        else (str(self.device),) * self.n_parties)
        if len(self.devices) != self.n_parties:
            raise ValueError(f"{self.n_parties} workers but "
                             f"{len(self.devices)} devices")
        self.round_timeout = float(round_timeout)
        self.connect_timeout = float(connect_timeout)
        self.retry = retry or RetryPolicy()
        self.breaker = CircuitBreaker(breaker_threshold)
        self._host = host
        self.channels: dict[int, transport.Channel] = {}
        self._procs: list = []
        self._dead: set[int] = set()
        self._nonce = 0
        self._run_id = 0
        self._bind_id = 0
        self._started = False
        # collective rounds relayed (a gather or a sum each)
        self._m_rounds = telemetry.REGISTRY.counter("distributed.rounds")

    # ------------------------------------------------------------- lifecycle
    def start(self) -> None:
        if self._started:
            return
        if any(torch.device(d).type == "cuda" for d in self.devices):
            # one build for every worker, before any of them needs it
            from repro_torch.kernels import histogram
            histogram.LIBRARY.load()
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.bind((self._host, 0))
        srv.listen(self.n_parties)
        host_addr, port = srv.getsockname()
        src_root = str(Path(__file__).resolve().parents[2])
        ctx = multiprocessing.get_context("spawn")
        old_pp = os.environ.get("PYTHONPATH")
        os.environ["PYTHONPATH"] = (src_root if not old_pp
                                    else src_root + os.pathsep + old_pp)
        try:
            for i in range(self.n_parties):
                p = ctx.Process(target=_worker_entry,
                                args=(host_addr, port, i, src_root,
                                      self.devices[i]), daemon=True)
                p.start()
                self._procs.append(p)
        finally:
            if old_pp is None:
                os.environ.pop("PYTHONPATH", None)
            else:
                os.environ["PYTHONPATH"] = old_pp
        srv.settimeout(self.connect_timeout)
        try:
            for _ in range(self.n_parties):
                sock, _addr = srv.accept()
                ch = transport.Channel(sock)
                hello = ch.recv(timeout=self.connect_timeout)
                if hello.get("op") != "hello":
                    raise ProtocolError(f"expected hello, got {hello}")
                idx = int(hello["party"])
                ch.party = idx
                self.channels[idx] = ch
        except (socket.timeout, TimeoutError) as e:
            self.shutdown()
            raise PartyDead(
                f"not all {self.n_parties} party workers connected within "
                f"{self.connect_timeout:.0f}s") from e
        finally:
            srv.close()
        self._started = True

    def shutdown(self) -> None:
        for p, ch in list(self.channels.items()):
            if p not in self._dead:
                try:
                    ch.send({"op": "shutdown"})
                except transport.TransportError:
                    pass
            ch.close()
        self.channels.clear()
        for proc in self._procs:
            proc.join(timeout=5.0)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=5.0)
        self._procs.clear()
        self._started = False

    # ----------------------------------------------------------------- plumbing
    def next_run_id(self) -> int:
        self._run_id += 1
        return self._run_id

    def new_bind_id(self) -> int:
        self._bind_id += 1
        return self._bind_id

    def _mark_failure(self, p: int, e: Exception) -> None:
        if isinstance(e, PartyDead):
            self._dead.add(p)
            ch = self.channels.get(p)
            if ch is not None:
                ch.close()

    def _send(self, p: int, msg: dict) -> None:
        if p in self._dead:
            raise PartyDead(f"party {p}: process is gone", parties=(p,))
        try:
            self.channels[p].send(msg)
        except PartyUnavailableError as e:
            self._mark_failure(p, e)
            raise

    def _recv_run(self, p: int, rid) -> dict:
        ch = self.channels[p]
        deadline = time.monotonic() + self.round_timeout
        while True:
            left = deadline - time.monotonic()
            if left <= 0:
                raise PartyTimeout(
                    f"party {p}: no protocol message within the "
                    f"{self.round_timeout:.1f}s round budget", parties=(p,))
            try:
                msg = ch.recv(timeout=left)
            except PartyUnavailableError as e:
                self._mark_failure(p, e)
                raise
            if msg.get("run") == rid and msg.get("op") in ("coll", "result",
                                                           "error"):
                return msg
            # anything else is superseded-run traffic or a late ack: skip

    def _abort(self, rid, active) -> None:
        for p in active:
            if p in self._dead:
                continue
            try:
                self.channels[p].send({"op": "abort", "run": rid})
            except transport.TransportError:
                self._mark_failure(p, PartyDead(f"party {p}", parties=(p,)))

    # -------------------------------------------------------------- run loop
    def run_once(self, rid, msgs: dict[int, dict], active) -> dict[int, Any]:
        """Drive one protocol run to completion: relay every collective
        round, return per-party results.  Raises PartyTimeout/PartyDead with
        the failure attributed to a party (after aborting the others)."""
        try:
            for p in active:
                self._send(p, msgs[p])
            while True:
                with tracing.TRACER.span("round", category="comm",
                                         rid=rid) as rspan:
                    got = {p: self._recv_run(p, rid) for p in active}
                    ops = {m["op"] for m in got.values()}
                    if "error" in ops:
                        bad = [p for p, m in got.items()
                               if m["op"] == "error"]
                        self._abort(rid, active)
                        raise RuntimeError("\n".join(
                            f"party {p} failed in {msgs[p]['name']!r}: "
                            f"{got[p].get('message')}\n"
                            f"{got[p].get('traceback', '')}" for p in bad))
                    if ops == {"result"}:
                        rspan.set(kind="result")
                        return {p: m["data"] for p, m in got.items()}
                    if ops != {"coll"}:
                        self._abort(rid, active)
                        raise ProtocolError(
                            f"mixed protocol messages {ops}")
                    seqs = {m["seq"] for m in got.values()}
                    kinds = {m["kind"] for m in got.values()}
                    if len(seqs) != 1 or len(kinds) != 1:
                        self._abort(rid, active)
                        raise ProtocolError(
                            f"desynchronized collective (seq {seqs}, "
                            f"kind {kinds})")
                    kind, seq = kinds.pop(), seqs.pop()
                    rspan.set(kind=kind, seq=seq)
                    self._m_rounds.inc()
                    n_arr = len(got[active[0]]["data"])
                    combined = []
                    for j in range(n_arr):
                        stack = np.stack([np.asarray(got[p]["data"][j])
                                          for p in active])
                        combined.append(
                            stack if kind == "gather"
                            else np.add.reduce(stack, axis=0,
                                               dtype=stack.dtype))
                    reply = {"op": "coll_result", "run": rid, "seq": seq,
                             "data": combined}
                    for p in active:
                        self._send(p, reply)
        except PartyUnavailableError:
            # abort EVERY active party, including the one the failure is
            # attributed to: a slow-but-alive party must learn its run was
            # superseded, or it will block on a coll_result that never
            # comes and swallow the next run's message as stale traffic
            # (_abort already skips dead parties and eats transport errors)
            self._abort(rid, active)
            raise

    def run_retrying(self, build_msgs, active) -> dict[int, Any]:
        """run_once under the retry policy + circuit breaker.

        Transport failures (timeout/dead) are retried with jittered
        exponential backoff and charged to the breaker; protocol-body
        exceptions (RuntimeError from a worker traceback) are not — a bug
        does not become less buggy on retry."""
        active = list(active)
        last: PartyUnavailableError | None = None
        for attempt in range(self.retry.attempts):
            for p in active:
                self.breaker.allow(p)         # raises CircuitOpenError
            rid = self.next_run_id()
            msgs = build_msgs(rid)
            name = msgs[active[0]]["name"] if active else "?"
            try:
                with tracing.TRACER.span(f"run.{name}", category="host",
                                         rid=rid, attempt=attempt):
                    out = self.run_once(rid, msgs, active)
            except PartyUnavailableError as e:
                last = e
                for p in (e.parties or active):
                    self.breaker.record_failure(p)
                if attempt + 1 < self.retry.attempts:
                    self.retry.backoff(attempt)
                continue
            for p in active:
                self.breaker.record_success(p)
            return out
        raise last

    # ------------------------------------------------------ request/response
    def request(self, p: int, msg: dict, *,
                timeout: float | None = None) -> dict:
        """One out-of-band round trip (ping/chaos/bind/ingest ops), matched
        on an echoed nonce so stale run traffic cannot satisfy it."""
        return self.request_many({p: msg}, timeout=timeout)[p]

    def request_many(self, msgs: dict[int, dict], *,
                     timeout: float | None = None) -> dict[int, dict]:
        """Out-of-band round trips to several workers at once: every
        message is sent before any reply is awaited (the sharded substrate's
        process-group set-up blocks in each worker until all have joined)."""
        nonces = {}
        for p, msg in msgs.items():
            if p in self._dead:
                raise PartyDead(f"party {p}: process is gone", parties=(p,))
            self._nonce += 1
            nonces[p] = self._nonce
            try:
                self.channels[p].send(dict(msg, nonce=self._nonce))
            except PartyUnavailableError as e:
                self._mark_failure(p, e)
                raise
        deadline = time.monotonic() + (timeout or self.round_timeout)
        out = {}
        for p, n in nonces.items():
            try:
                while True:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        raise PartyTimeout(
                            f"party {p}: no reply to {msgs[p].get('op')!r}",
                            parties=(p,))
                    reply = self.channels[p].recv(timeout=left)
                    if reply.get("nonce") != n:
                        continue
                    if reply.get("op") == "error":
                        raise RuntimeError(
                            f"party {p}: {reply.get('message')}")
                    out[p] = reply
                    break
            except PartyUnavailableError as e:
                self._mark_failure(p, e)
                raise
        return out

    def health(self, timeout: float = 2.0) -> dict[int, float | None]:
        """Ping every party; latency in seconds, None for the unreachable.
        Reads do not feed the circuit breaker — health is observation."""
        out: dict[int, float | None] = {}
        for p in range(self.n_parties):
            if p in self._dead or p not in self.channels:
                out[p] = None
                continue
            t0 = time.perf_counter()
            try:
                r = self.request(p, {"op": "ping"}, timeout=timeout)
                out[p] = (time.perf_counter() - t0
                          if r.get("op") == "pong" else None)
            except (PartyUnavailableError, RuntimeError):
                out[p] = None
        return out

    def chaos(self, party: int, mode: str, seconds: float = 0.0) -> None:
        """Arm a one-shot fault at a worker: its NEXT run message is dropped
        (``drop_run``), delayed (``delay_run``), or kills the process
        (``die``).  The fault-injection tests' entry point."""
        self.request(party, {"op": "chaos", "mode": mode, "seconds": seconds})

    def unavailable_parties(self) -> tuple[int, ...]:
        return tuple(sorted(self._dead | set(self.breaker.open_parties())))


# ------------------------------------------------------------------- ingest
def _source_spec(src) -> dict:
    if isinstance(src, CSVSource):
        return {"kind": "csv", **dataclasses.asdict(src)}
    if isinstance(src, PartyBlock):
        return {"kind": "block", "name": src.name, "x": src.x,
                "ids": src.ids, "y": src.y, "feature_ids": src.feature_ids,
                "feature_names": (list(src.feature_names)
                                  if src.feature_names else None)}
    if isinstance(src, DataSource):
        raise TypeError(
            f"cannot ship a {type(src).__name__} to a party worker — "
            f"distributed ingest takes CSVSource (loaded party-side) or a "
            f"materialized PartyBlock")
    raise TypeError(f"expected PartyBlock or CSVSource, got "
                    f"{type(src).__name__}")


def _assemble(coord: Coordinator, op: str, metas, n_bins: int):
    """Align the parties' hashed IDs, have each bin its rows of the common
    ordering (``op``: ``bin_block`` or ``stream_bin``) and stack the
    partition — the coordinator half shared by both ingest paths.  Returns
    ``(partition, y, common_hashed)``."""
    names = [m["name"] for m in metas]
    if len(set(names)) != len(names):
        raise ValueError(f"party names must be unique, got {names}")
    order = sorted(range(len(names)), key=lambda w: names[w])
    # per-party uniqueness was validated worker-side (the worker names the
    # party); align_hashed owns the fast path + loud-error contract
    positions, common = crypto.align_hashed(
        [np.asarray(metas[w]["hashes"]) for w in order],
        [names[w] for w in order], check_unique=False)
    groups, n_features = feature_groups(
        [metas[w].get("feature_ids") for w in order],
        [int(metas[w]["n_features"]) for w in order])

    feat_gid = _pad_groups(groups)
    m, fp = feat_gid.shape
    xb = np.zeros((m, len(common), fp), dtype=np.uint8)
    boundaries = np.zeros((n_features, max(n_bins - 1, 0)), dtype=np.float64)
    y, holder = None, None
    for i, w in enumerate(order):
        r = coord.request(w, {"op": op, "positions": positions[i],
                              "n_bins": int(n_bins)})
        xb_i = np.asarray(r["xb"])
        xb[i, :, : xb_i.shape[1]] = xb_i
        boundaries[groups[i]] = np.asarray(r["boundaries"])
        if r.get("y") is not None:
            if holder is not None:
                raise ValueError(
                    f"labels held by more than one party ({holder!r} and "
                    f"{names[w]!r}); exactly one party owns the labels")
            holder, y = names[w], np.asarray(r["y"])

    part = VerticalPartition(xb=xb, feat_gid=feat_gid,
                             n_features=n_features, boundaries=boundaries,
                             raw_parts=None,
                             party_names=tuple(names[w] for w in order))
    return part, y, common


def distributed_ingest(coord: Coordinator, sources, n_bins: int, *,
                       salt: str = crypto.DEFAULT_SALT,
                       validate: bool = False):
    """partition_from_blocks over the wire: load at the parties, align on
    hashed IDs only, bin party-locally, assemble the stacked partition.

    Mirrors the in-process path decision for decision (canonical sorted-name
    party order, pre-aligned fast path, sorted-hash common ordering,
    feature-id partition checks, exactly-one-label-holder), so the returned
    partition is bit-identical to central ingestion of the same blocks.
    ``common_ids`` holds the HASHED ids — raw IDs never reach the
    coordinator."""
    if validate:
        raise ValueError(
            "validate=True re-bins the assembled central matrix, which the "
            "distributed substrate never holds — validate on an in-process "
            "substrate instead")
    sources = list(sources)
    if len(sources) != coord.n_parties:
        raise ValueError(f"expected {coord.n_parties} party sources, got "
                         f"{len(sources)}")
    # Provisioning is the one sanctioned raw flow: each in-memory source is
    # shipped to ITS OWN party's worker process — the same trust domain, a
    # stand-in for the worker reading its silo's storage directly (CSV
    # sources ship as paths and are read worker-side).  The static
    # suppression below and the runtime allow_egress() are a deliberate
    # pair; see analysis/policy.py.
    with egress_runtime.allow_egress(
            "provisioning: a party's own block to its own worker"):
        metas = [coord.request(w, {"op": "load_block",  # egress: ok(provisioning — party's own raw block to its own worker process, same trust domain)
                                   "source": _source_spec(s)})
                 for w, s in enumerate(sources)]
    for w in range(len(metas)):
        metas[w] = dict(metas[w], hashes=coord.request(
            w, {"op": "hash_block_ids", "salt": salt})["hashes"])
    return _assemble(coord, "bin_block", metas, n_bins)


# --------------------------------------------------------- streaming ingest
def _stream_source_spec(src) -> dict:
    """Wire spec for a chunked source — what ships to a party worker so the
    worker can stream the data *locally*.  CSVs ship as a path (the file
    lives with the party; its raw rows never cross the wire); in-memory
    blocks ship once as arrays (tests / small silos); products ship their
    schema + version around an inner source spec."""
    from repro_torch import streaming
    if isinstance(src, streaming.DataProduct):
        s = src.schema
        return {"kind": "product", "name": src.name,
                "version": int(src.version),
                "schema": {"n_features": int(s.n_features),
                           "feature_ids": (list(s.feature_ids)
                                           if s.feature_ids is not None
                                           else None),
                           "feature_dtype": s.feature_dtype,
                           "id_kind": s.id_kind,
                           "has_labels": bool(s.has_labels)},
                "inner": _stream_source_spec(src.source)}
    if isinstance(src, (streaming.ChunkedCSVSource, CSVSource)):
        return {"kind": "csv_chunks", **dataclasses.asdict(src)}
    if isinstance(src, streaming.ArraySource):
        return dict(_source_spec(src.block), kind="block_chunks")
    if isinstance(src, PartyBlock):
        return dict(_source_spec(src), kind="block_chunks")
    if isinstance(src, DataSource):
        raise TypeError(
            f"cannot ship a {type(src).__name__} to a party worker — "
            f"distributed streaming takes chunked CSVs (streamed "
            f"party-side), blocks, or DataProducts over them")
    raise TypeError(f"expected a chunked source, PartyBlock or CSVSource, "
                    f"got {type(src).__name__}")


def stream_source_from_spec(spec: dict):
    """Worker-side inverse of :func:`_stream_source_spec`."""
    from repro_torch import streaming
    kind = spec["kind"]
    if kind == "product":
        s = spec["schema"]
        return streaming.DataProduct(
            name=spec["name"], version=int(spec["version"]),
            source=stream_source_from_spec(spec["inner"]),
            schema=streaming.ProductSchema(
                n_features=int(s["n_features"]),
                feature_ids=(tuple(int(f) for f in s["feature_ids"])
                             if s["feature_ids"] is not None else None),
                feature_dtype=s["feature_dtype"], id_kind=s["id_kind"],
                has_labels=bool(s["has_labels"])))
    if kind == "csv_chunks":
        return streaming.ChunkedCSVSource(
            path=spec["path"], name=spec.get("name"),
            id_column=spec.get("id_column", "id"),
            label_column=spec.get("label_column", "label"),
            delimiter=spec.get("delimiter", ","))
    if kind == "block_chunks":
        names = spec.get("feature_names")
        return streaming.ArraySource(PartyBlock(
            name=spec["name"], x=spec["x"], ids=spec["ids"],
            y=spec.get("y"), feature_ids=spec.get("feature_ids"),
            feature_names=tuple(names) if names else None))
    raise transport.ProtocolError(f"unknown stream source kind {kind!r}")


def distributed_streaming_ingest(coord: Coordinator, sources, n_bins: int, *,
                                 chunk_rows: int, capacity: int,
                                 salt: str = crypto.DEFAULT_SALT,
                                 append: bool = False):
    """Streamed ingest over the wire: each party worker scans and bins its
    own chunks process-side (``streaming.PartyStream`` held at the worker);
    the coordinator sees hashed IDs, sketch-derived boundaries, binned
    values and the aligned labels — never raw features or raw IDs.

    ``append=True`` extends the streams the workers already hold (one new
    source per party, worker order matching the original ingest) and
    re-assembles over the union — the distributed twin of
    ``Federation.ingest_append``.  Returns ``(partition, y, common_hashed)``
    exactly like :func:`distributed_ingest`."""
    sources = list(sources)
    if len(sources) != coord.n_parties:
        raise ValueError(f"expected {coord.n_parties} party sources, got "
                         f"{len(sources)}")
    # provisioning: same sanctioned raw flow as distributed_ingest — each
    # party's own chunked source goes to its own worker (in-memory array
    # sources ship raw; CSV sources ship as paths, read worker-side)
    with egress_runtime.allow_egress(
            "provisioning: a party's own chunked source to its own worker"):
        metas = [coord.request(w, {"op": "stream_scan",  # egress: ok(provisioning — party's own raw chunk source to its own worker process, same trust domain)
                                   "source": _stream_source_spec(s),
                                   "chunk_rows": int(chunk_rows),
                                   "capacity": int(capacity), "salt": salt,
                                   "append": bool(append)})
                 for w, s in enumerate(sources)]
    return _assemble(coord, "stream_bin", metas, n_bins)


def rollup_telemetry(coord: Coordinator, prefix: str) -> dict[int, dict]:
    """Pull each live worker's buffered spans + metric snapshot into this
    process: the spans join the session tracer, the metrics merge under
    ``<prefix><i>.`` (counters add).  Returns per-worker span and metric
    counts."""
    out: dict[int, dict] = {}
    for p in range(coord.n_parties):
        if p in coord._dead or p not in coord.channels:
            continue
        try:
            r = coord.request(p, {"op": "telemetry"})
        except (PartyUnavailableError, RuntimeError):
            continue
        for s in r.get("spans") or ():
            tracing.TRACER.adopt(s)
        telemetry.REGISTRY.merge(r.get("metrics") or {},
                                 prefix=f"{prefix}{p}.")
        out[p] = {"spans": len(r.get("spans") or ()),
                  "metrics": len(r.get("metrics") or ())}
    return out


# ------------------------------------------------------------------- substrate
class _DistCallable:
    """A distributed protocol program bound to a coordinator.

    Call convention matches the simulated substrate: the first ``n_party``
    args carry a leading (M, ...) party dimension (sliced per party before
    the wire), the rest are shared; the output is the per-party result
    stack as host arrays.  ``bind`` ships chosen argnums to the workers
    once (the serving engine's per-bucket seam) — later calls send None at
    those positions."""

    def __init__(self, substrate: "DistributedSubstrate", spec: dict,
                 n_party: int, n_shared: int, active=None):
        self.substrate = substrate
        self.spec = dict(spec)
        self.n_party = int(n_party)
        self.n_shared = int(n_shared)
        self.active = (tuple(int(p) for p in active) if active is not None
                       else tuple(range(substrate.n_parties)))
        self._bind_id = None
        self._bound_set: set[int] = set()

    @staticmethod
    def _slot(a, p):
        a = host(a)
        if isinstance(a, tuple) and hasattr(a, "_fields"):
            return type(a)(*(x[p] for x in a))
        return a[p]

    def _wire(self, k: int, a, p: int):
        """Worker ``p``'s share of host argument ``k``: its party's slice
        of a party argument, a shared argument whole."""
        return a if (a is None or k >= self.n_party) else self._slot(a, p)

    def _run_fields(self, p: int, active) -> dict:
        """The fields of worker ``p``'s run message that place it."""
        return {"party_index": p, "n_parties": len(active)}

    def _assemble(self, outs: dict, active):
        """The per-worker results as the program's output."""
        return _stack([outs[p] for p in active])

    def _copy(self) -> "_DistCallable":
        return _DistCallable(self.substrate, self.spec, self.n_party,
                             self.n_shared, self.active)

    def bind(self, *args) -> "_DistCallable":
        coord = self.substrate.coordinator
        bid = coord.new_bind_id()
        bound = tuple(k for k in (self.spec.get("bound") or ())
                      if k < len(args) and args[k] is not None)
        hosted = {k: host(args[k]) for k in bound}
        for p in self.active:
            shipped = {k: self._wire(k, a, p) for k, a in hosted.items()}
            coord.request(p, {"op": "bind", "bind": bid, "args": shipped})
        new = self._copy()
        new._bind_id = bid
        new._bound_set = set(bound)
        return new

    def __call__(self, *args):
        if len(args) > self.n_party + self.n_shared:
            raise TypeError(
                f"{self.spec['name']}: expected at most "
                f"{self.n_party + self.n_shared} args, got {len(args)}")
        coord = self.substrate.coordinator
        active = list(self.active)
        wire_args = [None if k in self._bound_set else host(a)
                     for k, a in enumerate(args)]

        def build(rid):
            msgs = {}
            for p in active:
                wire = [self._wire(k, a, p) for k, a in enumerate(wire_args)]
                msgs[p] = {"op": "run", "run": rid,
                           "name": self.spec["name"],
                           "payload": self.spec.get("payload") or {},
                           "args": wire, "bound": self._bind_id,
                           **self._run_fields(p, active)}
            return msgs

        outs = coord.run_retrying(build, active)
        return self._assemble(outs, active)


class DistributedSubstrate:
    """Party-per-process execution: one OS process per party, message-passing
    collectives, production fault tolerance.  Registered as "distributed" in
    the substrate registry; workers spawn lazily on first use, on
    ``device`` (None: the CUDA card — this raises at once on a host
    without one, before anything is spawned; pass "cpu" for CPU
    workers)."""

    name = "distributed"
    # program operands stay host arrays up to the wire
    host_operands = True

    def __init__(self, parties: int, *, device: torch.device | str | None = None,
                 host: str = "127.0.0.1", round_timeout: float = 120.0,
                 connect_timeout: float = 30.0,
                 retry: RetryPolicy | None = None,
                 breaker_threshold: int = 3):
        if parties < 1:
            raise ValueError(f"need at least 1 party, got {parties}")
        self.n_parties = int(parties)
        self.device = resolve_device(device)
        self._opts = dict(device=self.device, host=host,
                          round_timeout=round_timeout,
                          connect_timeout=connect_timeout, retry=retry,
                          breaker_threshold=breaker_threshold)
        self._coord: Coordinator | None = None

    @property
    def coordinator(self) -> Coordinator:
        if self._coord is None:
            self._coord = Coordinator(self.n_parties, **self._opts)
            self._coord.start()
        return self._coord

    # ----------------------------------------------------- Substrate protocol
    def program(self, fn, n_party: int, n_shared: int, *,
                distributed: dict | None = None, parties=None,
                sharded: dict | None = None, party_specs=None,
                shared_specs=None, out_specs=None):
        """The protocol body named by ``distributed``, bound to the
        coordinator; a rank-only body (``sharded``) and the sharded
        substrate's placements do not apply here."""
        if distributed is None:
            raise NotImplementedError(
                f"{getattr(fn, '__name__', fn)!r} has no distributed "
                f"protocol body — only forest fit/predict, F-LR predict and "
                f"the conformance toy protocol run party-per-process")
        return _DistCallable(self, distributed, n_party, n_shared,
                             active=parties)

    jit = program

    def compile(self, program):
        return program                         # already an executable protocol

    def aot_compile(self, program, *args):
        """Ship the program's model-side operands to the workers once (a
        bind, not a graph: the wave runs across processes)."""
        return program.bind(*args)

    def context(self):
        return contextlib.nullcontext()

    def exchange(self, op: str, payload: dict | None = None, *,
                 party: int | None = None, timeout: float | None = None):
        """Out-of-band request to one party (or all): the transport seam the
        Substrate protocol grew for this implementation."""
        coord = self.coordinator
        msg = dict(payload or {}, op=op)
        if party is not None:
            return coord.request(party, msg, timeout=timeout)
        return {p: coord.request(p, msg, timeout=timeout)
                for p in range(self.n_parties)
                if p not in coord._dead}

    def shutdown(self) -> None:
        if self._coord is not None:
            self._coord.shutdown()
            self._coord = None

    # ------------------------------------------------------------ operations
    def ingest_blocks(self, sources, n_bins: int, *,
                      salt: str = crypto.DEFAULT_SALT,
                      validate: bool = False):
        return distributed_ingest(self.coordinator, sources, n_bins,
                                  salt=salt, validate=validate)

    def ingest_stream(self, sources, n_bins: int, *,
                      salt: str = crypto.DEFAULT_SALT, validate: bool = False,
                      chunk_rows: int, capacity: int, append: bool = False):
        if validate:
            raise ValueError(
                "validate=True re-bins the assembled central matrix, which "
                "the distributed substrate never holds — validate on an "
                "in-process substrate instead")
        return distributed_streaming_ingest(
            self.coordinator, sources, n_bins, chunk_rows=chunk_rows,
            capacity=capacity, salt=salt, append=append)

    def health(self, timeout: float = 2.0):
        return self.coordinator.health(timeout=timeout)

    def collect_telemetry(self) -> dict[int, dict]:
        """Pull each live party's buffered spans + metric snapshot into this
        process: worker spans join the session tracer (so one export covers
        the whole federation) and party metrics merge under a ``party<i>.``
        prefix (counters add: the workers' counters are cumulative, so the
        merged value grows by a worker's whole count at every rollup).
        Returns per-party span and metric counts.  No-op (empty dict) if
        the coordinator was never started."""
        if self._coord is None:
            return {}
        return rollup_telemetry(self._coord, "party")

    def chaos(self, party: int, mode: str, seconds: float = 0.0):
        self.coordinator.chaos(party, mode, seconds)

    def unavailable_parties(self) -> tuple[int, ...]:
        if self._coord is None:
            return ()
        return self._coord.unavailable_parties()

    def __repr__(self) -> str:
        state = "up" if self._coord is not None else "cold"
        return (f"DistributedSubstrate(parties={self.n_parties}, "
                f"device={self.device}, {state})")
