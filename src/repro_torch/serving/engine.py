"""Serving engines — compile-once, bucketed, async-wave federated inference.

Serving traffic arrives in arbitrary batch sizes; a compiled program wants
static shapes.  The engine bridges the two as the JAX package's does:

  * requests are padded up to a small set of BUCKET row counts (default
    32/256/2048) and each bucket's prediction program is compiled exactly
    once, so steady-state traffic never recompiles — ``compile_count`` is
    the proof, asserted in tests/test_torch_serving.py.  On the card,
    "compiled" means captured: the substrate (``aot_compile``) records the
    bucket's program into one CUDA graph over a static input of
    (M, bucket, Fp) rows, and every wave of that bucket replays the graph
    — one launch for the whole program instead of its hundreds of small
    kernels.  The graph keeps the choices made while it was captured
    (``prediction._check_full_f32``'s host check among them: it runs once,
    at capture).  On the CPU the "compiled" program is the eager one;
  * oversized requests are chopped into waves of the largest bucket
    (micro-batching); per-wave latency / rows-per-second / party-sum
    payload bytes are recorded in ``wave_stats``;
  * waves execute **asynchronously**: ``dispatch_wave`` launches a wave
    and returns an :class:`InFlightWave` handle without blocking, and
    ``collect`` blocks on it, records its stats and strips padding.  On the
    card a wave is, on the server's own CUDA stream: its padded rows
    written into a pinned host staging buffer, copied (``non_blocking``)
    into the bucket's static input, the graph replayed, its static output
    copied into a pinned host buffer, and an event recorded — which
    ``collect`` waits on.  The staging and output buffers belong to RING
    SLOTS, not buckets: a slot goes back to the free list only when its
    wave is collected, so no host buffer is rewritten while a copy still
    reads or writes it, and two waves of one bucket in flight queue on the
    stream (the second's copy-in and replay behind the first's copy-out).
    ``serve_binned`` keeps at most ``max_inflight`` waves in flight, so
    host binning/padding of wave ``i+1`` overlaps device execution of wave
    ``i`` — bit-identical to the sync path (``max_inflight=1``), the same
    programs in the same order;
  * label decode (crypto.py) is applied in exactly one layer — ``collect``
    — so ``serve``, ``serve_binned`` and the RequestQueue all return
    decoded outputs with one consistent dtype, including zero-row requests
    (``empty_result``).

``ForestServer`` is the paper's one-round protocol (§4.2); with
``compact=True`` (default) a ``LeafTable`` (plan.py) switches the program
to the leaf-compacted membership mask.  ``BoostingServer`` and
``LinearServer`` put federated gradient boosting and the F-LR baseline
behind the *same* engine — ``Federation.serve`` dispatches on the model
family.  A server runs where its model's tensors are: on the card unless
the model was fitted or loaded with ``device="cpu"``.

On the sharded and party-per-process substrates (federation/sharded.py,
federation/distributed.py) a wave cannot be one graph: it runs across
processes.  There the substrate's ``aot_compile`` is a bind (the trees ship
to the ranks or workers once per bucket) and a wave takes the host path:
its padded rows go to the processes, whose answers come back as a host
array.  ``mesh=`` builds a server on a rank mesh of its own (the sharded
substrate; ``close()`` stops its ranks).  The engine picks the path by what
``aot_compile`` returned — a captured graph or not — never by the device.
Degraded serving lives there too: with ``allow_degraded`` a wave that
loses a party (``PartyUnavailableError``) is answered from the trees whose
split paths avoid every dead party's features (``ForestServer.
_execute_degraded``), exactly, and flagged in ``wave_stats``; without it
the error propagates.  In process ``allow_degraded`` is inert: no party
can be lost.

Prefer building servers through ``Federation.serve`` — the session
pre-binds its substrate, keeps servers fresh across model updates, and can
autotune the bucket set from observed traffic (serving/autotune.py).
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import convert
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.core import prediction
from repro_torch.core.tree import PartyTree
from repro_torch.core.types import ForestParams
from repro_torch.device import resolve_device
from repro_torch.federation import programs
from repro_torch.federation.substrate import (CAPTURE_LOCK, GraphProgram,
                                              ShardedSubstrate,
                                              SimulatedSubstrate)
from repro_torch.federation.transport import PartyUnavailableError
from repro_torch.observability import registry as telemetry
from repro_torch.observability import trace as tracing
from repro_torch.serving import plan
from repro_torch.serving.config import ServeConfig
from repro_torch.serving.metrics import busy_seconds

DEFAULT_BUCKETS = (32, 256, 2048)


def load_forest_trees(ckpt_dir: str, step: int | None = None,
                      device: torch.device | str | None = None) -> PartyTree:
    """Restore a fitted PartyTree stack (leading (M, T, ...) axes) from a
    ckpt/checkpoint.py snapshot — the artifact ``fit_resumable`` and
    ``Federation.save`` write, in either package — onto ``device`` (None:
    the CUDA card), each field in its PartyTree dtype.

    PartyTree is a NamedTuple, so its checkpoint keys are the field names
    (".is_leaf", ".leaf_stats", ...) — enough to rebuild it without a
    ``like`` tree."""
    device = resolve_device(device)
    if step is None:
        step = ckpt.latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    flat = ckpt.peek_checkpoint(ckpt_dir, step)
    keys = [f".{name}" for name in PartyTree._fields]
    if sorted(flat) != sorted(keys):
        raise ValueError(
            f"checkpoint at {ckpt_dir} step {step} is not a bare PartyTree "
            f"(keys {sorted(flat)})")
    return convert.party_trees_from_numpy(
        {name: flat[f".{name}"] for name in PartyTree._fields}, device)


class _Slot:
    """One ring slot: pinned host buffers for a wave's padded rows and its
    output, and the event its wave's copy-out records."""

    def __init__(self, in_bytes: int, out_bytes: int):
        self.x = torch.empty(in_bytes, dtype=torch.uint8, pin_memory=True)
        self.y = torch.empty(out_bytes, dtype=torch.uint8, pin_memory=True)
        self.event = torch.cuda.Event()

    @staticmethod
    def view(buf: torch.Tensor, shape, dtype: torch.dtype) -> torch.Tensor:
        n = int(np.prod(shape)) * dtype.itemsize
        return buf[:n].view(dtype).view(shape)


@dataclasses.dataclass
class InFlightWave:
    """Handle for a dispatched, not-yet-collected wave.

    ``out`` is the wave's raw output: on the card the pinned host buffer
    its copy-out is still filling (``event`` marks the end of the wave on
    the server's stream; ``slot`` owns the buffers, ``program`` keeps the
    replayed graph alive); on the CPU the computed tensor.  ``collect``
    resolves it."""

    out: Any
    bucket: int
    n_rows: int
    t0: float
    inflight_at_dispatch: int = 1
    # extra per-wave facts recorded by the dispatch path (e.g. the degraded
    # serving flag + dead-party list) — merged into the wave_stats entry
    info: dict | None = None
    # open trace span (tracing.TRACER.begin), finished at collect; None
    # when tracing is disabled
    span: Any = None
    event: Any = None
    slot: Any = None
    program: Any = None


class ModelServer:
    """Bucket / pad / compile-once / async-wave machinery, model-agnostic.

    Subclasses bind a model family by implementing:
      * ``_program()``     — the substrate-specialized predict closure;
      * ``_wave_args(xbt)``— the full ordered argument tuple for one wave
                             (model state + the padded request rows + any
                             shared args, in the program's order);
      * ``_prep(x_raw)``   — raw request rows -> (M, n, Fp) party rows;
      * ``_raw_out_dtype()``, ``_request_dtype()``, ``_wave_comm_bytes(b)``;
      * ``self.device``    — where the model state lives.

    The generic layer owns bucketing, compilation (graph capture), the
    in-flight ring, decode, padding strip, stats, and bucket retuning.
    """

    def _init_engine(self, *, buckets, substrate=None, partition=None,
                     decode: Callable | None = None, max_inflight: int = 1,
                     allow_degraded: bool = False,
                     n_features_per_party: int | None = None, mesh=None,
                     device: torch.device | None = None) -> None:
        self.buckets = self._check_buckets(buckets)
        if mesh is not None:
            if substrate is not None:
                raise ValueError("pass a mesh or a substrate, not both")
            substrate = ShardedSubstrate(mesh, device=device)
        # a server made on a mesh owns that mesh's ranks (close() stops them)
        self._owns_substrate = mesh is not None
        self.substrate = (substrate if substrate is not None
                          else SimulatedSubstrate())
        self.allow_degraded = bool(allow_degraded)
        self.partition = partition
        self.decode = decode
        if int(max_inflight) < 1:
            raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
        self.max_inflight = int(max_inflight)
        self.compile_count = 0
        # bounded: a long-running server must not leak one dict per wave
        self.wave_stats: collections.deque = collections.deque(maxlen=4096)
        # bucket -> (compiled program, its static input rows)
        self._exec: dict[int, tuple[Callable, torch.Tensor]] = {}
        self._request_fp = n_features_per_party
        self._n_inflight = 0
        self._wave_info = None
        # the card's wave path: the server's own stream and its free ring
        # slots (made on first use)
        self._stream = None
        self._free_slots: list[_Slot] = []
        # telemetry handles bound once — the per-wave path must not pay a
        # registry name lookup per wave
        self._m_waves = telemetry.REGISTRY.counter("serving.waves")
        self._m_rows = telemetry.REGISTRY.counter("serving.rows")
        self._m_latency = telemetry.REGISTRY.histogram(
            "serving.wave_latency_s")

    @staticmethod
    def _check_buckets(buckets) -> tuple[int, ...]:
        buckets = tuple(int(b) for b in buckets) if buckets else ()
        if not buckets or list(buckets) != sorted(set(buckets)) \
                or buckets[0] < 1:
            raise ValueError(f"buckets must be ascending/unique: {buckets}")
        return buckets

    # ------------------------------------------------------- family hooks
    def _program(self):
        raise NotImplementedError

    def _wave_args(self, xbt) -> tuple:
        raise NotImplementedError

    def _prep(self, x_raw: np.ndarray) -> np.ndarray:
        """Raw request rows -> (M, n, Fp) party rows.  The binned-tree
        default: bin + partition through the fit-time VerticalPartition."""
        if self.partition is None:
            raise ValueError("raw-row serving needs a VerticalPartition")
        return self.partition.bin_test(x_raw)

    def _raw_out_dtype(self):
        raise NotImplementedError

    def _request_dtype(self) -> torch.dtype:
        return torch.uint8

    def _wave_comm_bytes(self, bucket: int) -> int:
        return 0

    # ------------------------------------------------------- compile layer
    def _executable(self, bucket: int):
        """(compiled program, static input) of one bucket — compiled on
        first use, then reused for every wave of the bucket."""
        if bucket in self._exec:
            return self._exec[bucket]
        xbt = torch.zeros((self.n_parties, bucket, self._fp()),
                          dtype=self._request_dtype(), device=self.device)
        fn = self._program()
        with self.substrate.context():
            # the substrate owns what "compiled" means: a CUDA graph per
            # bucket on the card, the eager program on the CPU
            compiled = self.substrate.aot_compile(fn, *self._wave_args(xbt))
        self.compile_count += 1
        self._exec[bucket] = (compiled, xbt)
        return self._exec[bucket]

    def close(self) -> None:
        """Stop the ranks of a server made on a mesh of its own (a server
        built on a session's substrate leaves it to the session)."""
        if self._owns_substrate:
            self.substrate.shutdown()

    def warmup(self) -> "ModelServer":
        """Compile every bucket up front (the compile-once contract)."""
        for b in self.buckets:
            self._executable(b)
        return self

    def set_buckets(self, buckets) -> "ModelServer":
        """Retune the bucket set (serving/autotune.py drives this).

        Programs of buckets that survive the retune are kept — the
        compile-once contract holds *per autotune epoch*: after a retune +
        ``warmup()``, ``compile_count`` grows only by the genuinely new
        buckets and then stops again."""
        buckets = self._check_buckets(buckets)
        self._exec = {b: e for b, e in self._exec.items() if b in buckets}
        self.buckets = buckets
        self._free_slots = []         # slots are sized for the largest bucket
        telemetry.REGISTRY.counter("serving.autotune_epochs").inc()
        return self

    def _fp(self) -> int:
        """Per-party (padded) feature width of request rows."""
        bound = self._bound_fp()
        if bound is None:
            raise ValueError(
                "feature width unknown: pass n_features_per_party / a "
                "partition, or serve a binned batch before warmup()")
        return bound

    def _bound_fp(self) -> int | None:
        if self.partition is not None:
            return int(self.partition.feat_gid.shape[1])
        return None if self._request_fp is None else int(self._request_fp)

    def _check_fp(self, fp: int) -> None:
        """Reject rows whose per-party width disagrees with the width the
        compiled programs were (or will be) specialized for — an opaque
        shape error mid-wave otherwise."""
        bound = self._bound_fp()
        if bound is None:
            self._request_fp = int(fp)
        elif int(fp) != bound:
            raise ValueError(
                f"request rows have per-party feature width {fp} but this "
                f"server is bound to width {bound} (bucket programs are "
                f"shape-specialized; re-bin through the server's partition "
                f"or stand up a server for the new width)")

    # ---------------------------------------------------------- wave layer
    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def dispatch_wave(self, xb_parts: np.ndarray) -> InFlightWave:
        """Launch one wave without blocking on its result.

        ``xb_parts`` is (M, n, Fp) with ``0 < n <= buckets[-1]``; the rows
        are padded to the wave's bucket and handed to the bucket's compiled
        program.  On the card the wave is enqueued on the server's stream
        and this returns at once — host work for the next wave (binning,
        coalescing, padding) overlaps device execution of this one."""
        xb_parts = np.asarray(xb_parts)
        m, n, fp = xb_parts.shape
        if m != self.n_parties:
            raise ValueError(f"expected {self.n_parties} parties, got {m}")
        if not 0 < n <= self.buckets[-1]:
            raise ValueError(
                f"wave of {n} rows: must be in (0, {self.buckets[-1]}] — "
                f"chop oversized requests into waves (serve_binned does)")
        self._check_fp(fp)
        bucket = self._bucket_for(n)
        compiled, xs = self._executable(bucket)
        span = tracing.TRACER.begin("serve.wave", category="compute",
                                    bucket=bucket, rows=n)
        t0 = time.perf_counter()
        self._wave_info = None
        # the host's part of the wave: pad, stage, launch, record
        with tracing.TRACER.span("serve.dispatch", bucket=bucket, rows=n):
            if isinstance(compiled, GraphProgram):
                wave = self._dispatch_card(compiled, xs, xb_parts, bucket)
            else:
                # the host path: the CPU's eager program, or a bound
                # protocol of the party-per-process substrate (answers as
                # host arrays)
                padded = np.zeros((m, bucket, fp), xb_parts.dtype)
                padded[:, :n] = xb_parts
                wave = InFlightWave(out=self._execute(
                    compiled, torch.as_tensor(padded, dtype=xs.dtype)),
                    bucket=bucket, n_rows=n, t0=t0)
        self._n_inflight += 1
        wave.n_rows, wave.t0, wave.span = n, t0, span
        wave.inflight_at_dispatch = self._n_inflight
        wave.info = self._wave_info
        return wave

    def _slot(self) -> _Slot:
        """A free ring slot whose buffers hold a wave of the largest bucket
        — a new one when every slot is in flight, so the ring grows to the
        deepest in-flight count (``max_inflight`` under ``serve_binned``
        and the queue) and stays there."""
        top = self.buckets[-1]
        in_bytes = (self.n_parties * top * self._fp()
                    * self._request_dtype().itemsize)
        out_bytes = self.n_parties * top * 8     # (M, rows) of 8-byte values
        while self._free_slots:
            slot = self._free_slots.pop()
            if slot.x.numel() >= in_bytes and slot.y.numel() >= out_bytes:
                return slot
        return _Slot(in_bytes, out_bytes)

    def _dispatch_card(self, compiled, xs: torch.Tensor, xb_parts, bucket):
        """One wave on the card, enqueued on the server's stream: pinned
        staging -> static input -> replay -> pinned output -> event."""
        n = xb_parts.shape[1]
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        slot = self._slot()
        staged = _Slot.view(slot.x, xs.shape, xs.dtype)
        host = staged.numpy()
        host[:, :n] = xb_parts
        host[:, n:] = 0
        try:
            with CAPTURE_LOCK, torch.cuda.stream(self._stream):
                xs.copy_(staged, non_blocking=True)
                out = self._execute(compiled, xs)
                out_host = _Slot.view(slot.y, out.shape, out.dtype)
                out_host.copy_(out, non_blocking=True)
                slot.event.record(self._stream)
        except BaseException:
            self._stream.synchronize()           # nothing reads the slot now
            self._free_slots.append(slot)
            raise
        return InFlightWave(out=out_host, bucket=bucket, n_rows=n, t0=0.0,
                            event=slot.event, slot=slot, program=compiled)

    def _execute(self, compiled, xbt):
        """Launch one compiled wave — the failure seam (ForestServer's
        degraded serving catches a party's failure here)."""
        return compiled(*self._wave_args(xbt))

    def collect(self, wave: InFlightWave) -> np.ndarray:
        """Block on a dispatched wave; record stats, strip padding, decode.

        Under async dispatch ``latency_s`` spans launch -> ready, so for
        waves that queued behind earlier in-flight work it includes queueing
        time (``inflight_at_dispatch`` records the ring depth at launch)."""
        with tracing.TRACER.span("serve.collect", bucket=wave.bucket):
            if wave.event is not None:
                with tracing.TRACER.span("serve.wait"):
                    wave.event.synchronize()
                out = wave.out.numpy().copy()
                self._free_slots.append(wave.slot)
            elif torch.is_tensor(wave.out):
                out = wave.out.detach().cpu().numpy()
            else:
                out = np.asarray(wave.out)
            dt = time.perf_counter() - wave.t0
            tracing.TRACER.finish(wave.span)
            self._n_inflight -= 1
            self._m_waves.inc()
            self._m_rows.inc(wave.n_rows)
            self._m_latency.observe(dt)
            entry = {
                "bucket": wave.bucket, "n_rows": wave.n_rows,
                "t0": wave.t0, "latency_s": dt,
                "rows_per_s": wave.n_rows / max(dt, 1e-12),
                "inflight": wave.inflight_at_dispatch,
                "comm_bytes": self._wave_comm_bytes(wave.bucket),
            }
            if wave.info:
                entry.update(wave.info)
            self.wave_stats.append(entry)
            return self._finalize(self._strip(out, wave.n_rows))

    def abandon(self, waves) -> None:
        """Collect-and-discard in-flight handles whose results are no longer
        wanted (a failed pump discarding its ring).  Keeps the in-flight
        counter honest — the waves did run — while suppressing their own
        errors (the caller is already propagating the original one)."""
        for wave in waves:
            try:
                self.collect(wave)
            except Exception:                        # noqa: BLE001
                pass

    def _strip(self, out, n: int) -> np.ndarray:
        """Master-side rows of a program output, padding stripped.

        The aggregated serving programs produce exactly two shapes:
        ``(rows,)`` (the shared result, what the port's programs return) or
        ``(M, rows)`` (a per-party stack whose row 0 is the shared result).
        Anything else (per-tree ``aggregate=False`` stacks, future
        multi-output programs) must not be sliced silently."""
        out = np.asarray(out)
        if out.ndim == 1:
            return out[:n]
        if out.ndim == 2 and out.shape[0] == self.n_parties:
            return out[0, :n]
        raise ValueError(
            f"program output has unexpected shape {out.shape}: the serving "
            f"path expects (rows,) (the shared result) or "
            f"({self.n_parties}, rows) (a per-party stack); per-tree / "
            f"multi-output programs need their own collect handling")

    def _finalize(self, out: np.ndarray) -> np.ndarray:
        """Decode lives here, and only here (one layer for every caller)."""
        return self.decode(out) if self.decode is not None else np.asarray(out)

    def empty_result(self) -> np.ndarray:
        """The zero-row result, produced by the same decode path as real
        waves — so its dtype matches non-empty outputs for every task and
        crypto setting (e.g. regression_unmasker promotes to float64)."""
        return self._finalize(np.empty((0,), self._raw_out_dtype()))

    # ---------------------------------------------------------- serve layer
    def _serve_wave(self, xb_parts: np.ndarray) -> np.ndarray:
        return self.collect(self.dispatch_wave(xb_parts))

    def serve_binned(self, xb_parts: np.ndarray, *,
                     max_inflight: int | None = None) -> np.ndarray:
        """Serve pre-binned, pre-partitioned rows: (M, n, Fp) -> (n,).

        Chops into waves of at most the largest bucket and pumps them
        through the in-flight ring: up to ``max_inflight`` waves run on
        the device while the host pads the next ones; collection is FIFO,
        so outputs are bit-identical to the sync path."""
        xb_parts = np.asarray(xb_parts)
        m, n, fp = xb_parts.shape
        if m != self.n_parties:
            raise ValueError(f"expected {self.n_parties} parties, got {m}")
        if n == 0:                                    # empty batch: no wave
            return self.empty_result()
        k = self.max_inflight if max_inflight is None else max(1, max_inflight)
        ring: collections.deque[InFlightWave] = collections.deque()
        outs, lo = [], 0
        try:
            while lo < n or ring:
                while lo < n and len(ring) < k:       # fill the ring
                    hi = min(lo + self.buckets[-1], n)
                    ring.append(self.dispatch_wave(xb_parts[:, lo:hi]))
                    lo = hi
                outs.append(self.collect(ring.popleft()))  # backpressure
        except BaseException:
            self.abandon(ring)                        # keep inflight honest
            raise
        return np.concatenate(outs) if len(outs) > 1 else outs[0]

    def serve(self, x_test: np.ndarray) -> np.ndarray:
        """Serve raw feature rows (n, F) — the family's _prep does the
        partition/bin/standardize step; decode is applied per wave."""
        return self.serve_binned(self._prep(np.asarray(x_test)))

    def serve_parties(self, blocks, *, salt=None):
        """Serve per-party request blocks keyed by (hashed) sample IDs.

        ``blocks`` are PartyBlocks/DataSources — one per fit-time party,
        matched by name, rows in any order and possibly superset (each
        region ships whatever extract it has).  The engine re-aligns them on
        hashed IDs, drops non-common rows, bins party-locally with the
        fit-time boundaries and dispatches as usual.  Returns
        ``(ids, predictions)`` in the canonical aligned order.
        """
        from repro_torch.core import crypto
        if self.partition is None:
            raise ValueError("party-block serving needs the fit-time "
                             "VerticalPartition bound to the server")
        ids, xb = self.partition.bin_party_blocks(
            blocks, salt=salt if salt is not None else crypto.DEFAULT_SALT)
        return ids, self.serve_binned(xb)

    # ------------------------------------------------------------ reporting
    def stats_summary(self) -> dict:
        """p50/p95/p99 latency + aggregate throughput over recorded waves.

        ``comm_bytes_total`` sums every recorded wave's party-sum payload,
        so it stays honest under mixed-bucket traffic (per-wave values live
        in ``wave_stats``).  With no recorded waves the record is
        well-formed zeros (same keys, zero counts/latencies) — a
        just-spawned or fully drained cell aggregates into fleet metrics
        without special casing."""
        if not self.wave_stats:
            return {"waves": 0, "rows": 0, "p50_ms": 0.0, "p95_ms": 0.0,
                    "p99_ms": 0.0, "rows_per_s": 0.0, "comm_bytes_total": 0,
                    "compile_count": self.compile_count}
        lat = np.array([w["latency_s"] for w in self.wave_stats])
        rows = sum(w["n_rows"] for w in self.wave_stats)
        # busy time = union of the [t0, t0+latency] wave intervals: async
        # waves overlap by design, so summing latencies would double-count
        # and understate throughput by ~max_inflight; idle gaps between
        # traffic bursts don't count as busy either way
        busy = busy_seconds((w["t0"], w["t0"] + w["latency_s"])
                            for w in self.wave_stats)
        return {"waves": len(lat), "rows": rows,
                "p50_ms": float(np.percentile(lat, 50) * 1e3),
                "p95_ms": float(np.percentile(lat, 95) * 1e3),
                "p99_ms": float(np.percentile(lat, 99) * 1e3),
                "rows_per_s": rows / max(busy, 1e-12),
                "comm_bytes_total": sum(w["comm_bytes"]
                                        for w in self.wave_stats),
                "compile_count": self.compile_count}

    #: canonical name; ``stats_summary`` predates it and is kept as an alias.
    stats = stats_summary


class ForestServer(ModelServer):
    """Batched one-round prediction server over a fitted federated forest.

    Args:
      trees: PartyTree stack with leading (M, T, ...) axes (all parties'
        partial trees — what fit() produces and checkpoints store), on the
        device the server runs on.
      params: the forest's ForestParams (static compile keys).
      buckets: ascending batch-row buckets; requests pad to the smallest
        fitting bucket, larger ones run in waves of the biggest.
      compact: serve through the leaf-compacted program (LeafTable).
      substrate: where the protocol runs (the simulated one by default).
      mesh: a rank mesh (launch/mesh.py) to run on instead — the sharded
        substrate, trees split over its (parties, trees) ranks.
      partition: optional VerticalPartition for binning raw feature rows.
      decode: optional label decode applied to served outputs (crypto.py).
      max_inflight: in-flight wave ring depth (1 = synchronous waves).
      allow_degraded: on the party-per-process substrate, answer a wave
        that loses a party from the surviving trees (exact) instead of
        raising; inert in process (see the module docstring).
    """

    def __init__(self, trees: PartyTree, params: ForestParams, *,
                 buckets: tuple[int, ...] = DEFAULT_BUCKETS,
                 compact: bool = True, mask_dtype: torch.dtype = torch.uint8,
                 vote_impl: str = "einsum", substrate=None, partition=None,
                 decode: Callable | None = None, leaf_pad_multiple: int = 8,
                 max_inflight: int = 1, allow_degraded: bool = False,
                 n_features_per_party: int | None = None, mesh=None):
        self.params = params
        self.compact = compact
        self.mask_dtype = mask_dtype
        self.vote_impl = vote_impl
        self._leaf_pad = leaf_pad_multiple
        self._init_engine(
            buckets=buckets, substrate=substrate, partition=partition,
            decode=decode, max_inflight=max_inflight,
            allow_degraded=allow_degraded,
            n_features_per_party=n_features_per_party, mesh=mesh,
            device=torch.as_tensor(trees.is_leaf).device)
        self.refresh(trees)

    # ------------------------------------------------------------ factories
    @classmethod
    def from_forest(cls, forest, **kw) -> "ForestServer":
        """Wrap a fitted core.forest.FederatedForest (binning + decode ride
        along, so the server accepts raw feature rows)."""
        if forest.trees_ is None:
            raise ValueError("forest is not fitted: call fit() first")
        kw.setdefault("partition", forest.partition_)
        kw.setdefault("decode", forest._decode)
        return cls(forest.trees_, forest.params, **kw)

    from_model = from_forest

    @classmethod
    def from_checkpoint(cls, ckpt_dir: str, params: ForestParams,
                        step: int | None = None, *,
                        device: torch.device | str | None = None,
                        substrate: Any = "simulated", mesh=None,
                        **kw) -> "ForestServer":
        """Checkpoint -> serving, through a Federation session on
        ``device`` (None: the CUDA card) and ``substrate`` (a registered
        name or a built substrate; "distributed" spawns the party
        processes, which the server's ``close()`` stops) — or, with
        ``mesh``, the sharded substrate on that rank mesh: the session
        rehydrates the fitted forest handle (reconstructing the label
        decode where possible) and binds the server to its substrate.  The
        party count comes from the checkpointed stack itself (a mesh whose
        "parties" axis disagrees is refused)."""
        from repro_torch.federation import Federation
        trees = load_forest_trees(ckpt_dir, step, device=device)
        fed = Federation(parties=int(trees.is_leaf.shape[0]), device=device,
                         substrate="sharded" if mesh is not None
                         else substrate, mesh=mesh)
        # fit-time privacy flags steer load's decode reconstruction; the
        # rest of kw configures the server itself
        model_kw = {k: kw.pop(k) for k in ("encrypt_labels",
                                           "mask_regression") if k in kw}
        model = fed.load(ckpt_dir, params, step=step, trees=trees,
                         partition=kw.pop("partition", None),
                         decode=kw.pop("decode", None), **model_kw)
        config = kw.pop("config", None)
        if config is None:
            config = ServeConfig(
                buckets=kw.pop("buckets", None),
                compact=kw.pop("compact", True),
                max_inflight=kw.pop("max_inflight", 1),
                allow_degraded=kw.pop("allow_degraded", False))
        server = fed.serve(model, config, server_cls=cls, **kw)
        # the session was this call's own: its processes are the server's
        server._owns_substrate = isinstance(substrate, str) or \
            mesh is not None
        return server

    # -------------------------------------------------------- model binding
    @staticmethod
    def model_token(model) -> tuple:
        """Token of the model state a server was built from — object
        entries compare by identity, value entries by equality
        (session._token_matches); ``Federation.serve`` refreshes the cached
        server when the token changes.  The partition rides in the token
        because the server bins raw request rows with the fit-time
        boundaries: after an ``ingest_append`` + refit the boundaries moved,
        and serving with the stale grid would silently mis-bin every
        request."""
        return (model.trees_, model.partition_)

    def refresh_from(self, model) -> "ForestServer":
        """Rebind to a refreshed model: trees AND the request-path state
        (partition for binning, label decode) — a refit on appended rows
        changes all three."""
        if model.partition_ is not None:
            self.partition = model.partition_
        if model._decode is not None:
            self.decode = model._decode
        return self.refresh(model.trees_)

    def refresh(self, trees: PartyTree) -> "ForestServer":
        """(Re)bind the server to a PartyTree stack.

        Called at construction, and again by ``Federation.serve`` whenever a
        model's ``trees_`` changed underneath a cached server (e.g. a
        ``fit_resumable`` continuation extended the forest): the LeafTable
        plan is rebuilt and compiled programs (captured graphs) are dropped
        — their shapes and addresses belong to the old stack.
        ``compile_count`` keeps counting up, so the compile-once contract
        stays observable across refreshes."""
        self.trees = PartyTree(*(torch.as_tensor(a) for a in trees))
        self.device = self.trees.is_leaf.device
        self.n_parties = int(self.trees.is_leaf.shape[0])
        self.leaf_table = (plan.build_leaf_table(
            self.trees, self.params, pad_multiple=self._leaf_pad)
            if self.compact else None)
        # in-flight waves keep their own graph alive until collected
        self._exec = {}
        # alive-party tuple -> (bound runner, sliced trees, sliced leaf_idx,
        # surviving tree count): the degraded-serving fast path
        self._degraded: dict[tuple, tuple] = {}
        return self

    # ------------------------------------------------- degraded serving
    def _execute(self, compiled, xbt):
        try:
            return super()._execute(compiled, xbt)
        except PartyUnavailableError as err:
            if not self.allow_degraded or not err.parties:
                raise
            return self._execute_degraded(err, xbt)

    def _execute_degraded(self, err: PartyUnavailableError, xbt):
        """Answer a wave from the trees whose split paths avoid every dead
        party's features (their membership masks over the surviving parties
        intersect to exactly the full-federation leaf assignment, so the
        served predictions are exact — just from a smaller forest).  The
        wave is flagged ``degraded`` with the dead-party list and the
        surviving tree count in wave_stats."""
        from repro_torch.federation import distributed
        sub = self.substrate
        known = getattr(sub, "unavailable_parties", lambda: ())()
        dead = tuple(sorted(set(err.parties) | set(known)))
        alive = tuple(p for p in range(self.n_parties) if p not in dead)
        if not alive:
            raise err
        cached = self._degraded.get(alive)
        if cached is None:
            sel = distributed.surviving_trees(self.trees, dead)
            if sel.size == 0:
                raise PartyUnavailableError(
                    f"cannot serve degraded: every tree splits on a dead "
                    f"party's features (dead={list(dead)})", parties=dead)
            idx = torch.as_tensor(sel, device=self.device)
            trees = PartyTree(*(a[:, idx] for a in self.trees))
            lt = (None if self.leaf_table is None
                  else self.leaf_table.leaf_idx[idx])
            prog = programs.forest_predict_program(
                sub, self.params, compact=lt is not None,
                mask_dtype=self.mask_dtype, vote_impl=self.vote_impl,
                parties=alive)
            args = (trees,) if lt is None else (trees, None, lt)
            runner = sub.aot_compile(prog, *args)
            cached = (runner, trees, lt, int(sel.size))
            self._degraded[alive] = cached
        runner, trees, lt, n_trees = cached
        out = runner(*((trees, xbt) if lt is None else (trees, xbt, lt)))
        self._wave_info = {"degraded": True, "dead_parties": list(dead),
                           "n_trees": n_trees}
        return np.asarray(out)[0]     # 1-D: _strip's reduced-output shape

    # ------------------------------------------------------------ hooks
    def _program(self):
        return programs.forest_predict_program(
            self.substrate, self.params, compact=self.leaf_table is not None,
            mask_dtype=self.mask_dtype, vote_impl=self.vote_impl)

    def _wave_args(self, xbt) -> tuple:
        shared = (() if self.leaf_table is None
                  else (self.leaf_table.leaf_idx,))
        return (self.trees, xbt) + shared

    def _raw_out_dtype(self):
        # the port's vote is an argmax (int64), its regression mean float32
        return (np.int64 if self.params.task == "classification"
                else np.float32)

    def _wave_comm_bytes(self, bucket: int) -> int:
        n_cols = (self.params.n_nodes if self.leaf_table is None
                  else self.leaf_table.capacity)
        n_trees = int(self.trees.is_leaf.shape[1])   # actual stack, not
        return prediction.mask_comm_bytes(           # params (fit_resumable
            n_trees, bucket, n_cols, self.mask_dtype)  # chunks can be partial)


class BoostingServer(ModelServer):
    """Bucketed async serving for federated gradient boosting.

    The per-round trees (each a T=1 PartyTree) are stacked along the tree
    dim and served through ONE substrate-specialized program: the paper's
    one-round membership protocol with ``aggregate=False`` per-round outputs
    and the boosting reduction (base + lr * Σ rounds, thresholded for the
    binary task) fused in-program — so one wave = one party sum for the
    whole ensemble, exactly like the forest path.  ``base`` is a float32
    scalar tensor on the model's device.  Leaf compaction applies unchanged
    (per-round trees are ordinary PartyTrees)."""

    def __init__(self, trees: list, base: float, params, *,
                 buckets: tuple[int, ...] = DEFAULT_BUCKETS,
                 compact: bool = True, mask_dtype: torch.dtype = torch.uint8,
                 substrate=None, partition=None, leaf_pad_multiple: int = 8,
                 max_inflight: int = 1,
                 n_features_per_party: int | None = None, mesh=None):
        self.params = params                     # BoostParams
        self.compact = compact
        self.mask_dtype = mask_dtype
        self._leaf_pad = leaf_pad_multiple
        self._init_engine(
            buckets=buckets, substrate=substrate, partition=partition,
            decode=None, max_inflight=max_inflight,
            n_features_per_party=n_features_per_party, mesh=mesh,
            device=trees[0].is_leaf.device)
        self._rebind(trees, base)

    @classmethod
    def from_model(cls, model, **kw) -> "BoostingServer":
        """Wrap a fitted core.boosting.FederatedBoosting."""
        if not model.trees_:
            raise ValueError("fit the boosting model first")
        kw.pop("decode", None)                   # boosting has no crypto decode
        kw.setdefault("partition", getattr(model, "_partition", None))
        return cls(model.trees_, model.base_, model.params, **kw)

    @staticmethod
    def model_token(model) -> tuple:
        t = model.trees_
        return (t, len(t), t[-1] if t else None, float(model.base_))

    def refresh_from(self, model) -> "BoostingServer":
        return self._rebind(model.trees_, model.base_)

    def _rebind(self, trees: list, base: float) -> "BoostingServer":
        from repro_torch.core.boosting import stack_rounds
        self.trees = stack_rounds(trees)         # (M, R, ...) PartyTree
        self.device = self.trees.is_leaf.device
        self.base = torch.tensor(base, dtype=torch.float32,
                                 device=self.device)
        self.n_parties = int(self.trees.is_leaf.shape[0])
        self.leaf_table = (plan.build_leaf_table(
            self.trees, self.params.tree_params(),
            pad_multiple=self._leaf_pad) if self.compact else None)
        self._exec = {}
        return self

    def _program(self):
        return programs.boosting_predict_program(
            self.substrate, self.params,
            compact=self.leaf_table is not None, mask_dtype=self.mask_dtype)

    def _wave_args(self, xbt) -> tuple:
        shared = (() if self.leaf_table is None
                  else (self.leaf_table.leaf_idx,))
        return (self.trees, xbt, self.base) + shared

    def _raw_out_dtype(self):
        return np.int32 if self.params.task == "binary" else np.float32

    def _wave_comm_bytes(self, bucket: int) -> int:
        n_cols = (self.params.tree_params().n_nodes if self.leaf_table is None
                  else self.leaf_table.capacity)
        n_rounds = int(self.trees.is_leaf.shape[1])
        return prediction.mask_comm_bytes(n_rounds, bucket, n_cols,
                                          self.mask_dtype)


class LinearServer(ModelServer):
    """Bucketed async serving for the F-LR baseline.

    Request rows are split into per-party raw blocks, standardized with the
    fit-time moments and served through the single-party-sum joint-logit
    program — float32 party rows instead of binned uint8, everything else
    (buckets, compile-once, the in-flight ring) identical to the tree
    engines.  A wave's float32 products run at the bucket's row count, so
    cuBLAS may pick another kernel than ``predict`` at its own; the labels
    are held equal to ``predict``'s (tests/test_torch_serving.py)."""

    def __init__(self, model, *, buckets: tuple[int, ...] = DEFAULT_BUCKETS,
                 substrate=None, max_inflight: int = 1, mesh=None):
        self.model = model                       # fitted FederatedLinear
        self.task = model.task
        self._init_engine(
            buckets=buckets, substrate=substrate,
            partition=getattr(model, "_partition", None), decode=None,
            max_inflight=max_inflight, mesh=mesh, device=model._w.device)
        self._rebind(model)

    @classmethod
    def from_model(cls, model, **kw) -> "LinearServer":
        if getattr(model, "_w", None) is None:
            raise ValueError("fit the F-LR model first")
        kw.pop("decode", None)
        kw.pop("compact", None)                  # no heap to compact
        kw.pop("partition", None)                # the model owns its split
        kw.pop("allow_degraded", None)
        return cls(model, **kw)

    @staticmethod
    def model_token(model) -> tuple:
        return (model._w,)

    def refresh_from(self, model) -> "LinearServer":
        return self._rebind(model)

    def _rebind(self, model) -> "LinearServer":
        self.model = model
        self.w = model._w                        # (M, Fmax) party blocks
        self.device = self.w.device
        b = model._b
        self.b = b[0] if b.ndim else b           # summed: identical per party
        self.n_parties = int(self.w.shape[0])
        self._exec = {}
        return self

    def _program(self):
        return programs.linear_predict_program(self.substrate, self.task)

    def _wave_args(self, xbt) -> tuple:
        return (xbt, self.w, self.b)

    def _prep(self, x_raw: np.ndarray) -> np.ndarray:
        return self.model._standardized(self.model._blocks(x_raw))

    def serve_parties(self, blocks, *, salt=None):
        """Serve per-party raw request blocks keyed by (hashed) sample IDs.

        Same re-alignment path as the tree engines (name matching, hashed-ID
        intersection, fit-time column order) — but the aligned rows stay raw
        and are standardized with the fit-time moments instead of binned.
        Returns ``(ids, predictions)`` in the canonical aligned order."""
        from repro_torch.core import crypto
        if self.partition is None:
            raise ValueError("party-block serving needs the fit-time "
                             "VerticalPartition bound to the server (fit "
                             "the F-LR model on a VerticalPartition)")
        ids, raw_parts = self.partition.raw_party_rows(
            blocks, salt=salt if salt is not None else crypto.DEFAULT_SALT)
        return ids, self.serve_binned(self.model._standardized(raw_parts))

    def _bound_fp(self) -> int | None:
        return int(self.w.shape[-1])             # fit-time padded width

    def _request_dtype(self) -> torch.dtype:
        return torch.float32

    def _raw_out_dtype(self):
        return np.int32 if self.task == "classification" else np.float32


def server_for(model, substrate=None) -> type[ModelServer]:
    """The engine class serving a fitted model's family — the dispatch
    behind ``Federation.serve`` (a thin ModelServer dispatch over the
    Estimator protocol).  With ``substrate``, a family the substrate cannot
    run raises here rather than at the first wave: the party-per-process
    substrate has no boosting predict body (nor has the JAX package's)."""
    from repro_torch.core.boosting import FederatedBoosting
    from repro_torch.core.fedlinear import FederatedLinear
    from repro_torch.core.forest import FederatedForest
    if isinstance(model, FederatedForest):
        return ForestServer
    if isinstance(model, FederatedBoosting):
        if getattr(substrate, "name", None) == "distributed":
            raise NotImplementedError(
                f"boosting has no protocol body on the "
                f"{substrate.name!r} substrate: serve it in process")
        return BoostingServer
    if isinstance(model, FederatedLinear):
        return LinearServer
    if hasattr(model, "trees_") and hasattr(getattr(model, "trees_", None),
                                            "is_leaf"):
        return ForestServer                      # duck-typed forest handle
    raise TypeError(f"no serving engine for model family "
                    f"{type(model).__name__}")
