"""Request queue with continuous micro-batching over a serving engine.

Requests of arbitrary row counts are enqueued; ``drain()`` coalesces pending
rows into waves (many small requests share one program launch — one
graph replay on the card; a huge request spans several) and pumps them
through the engine's bucketed, compile-once path as a **two-phase async
pipeline**: fill the bounded in-flight ring (``dispatch_wave`` —
non-blocking: the wave is enqueued on the server's CUDA stream), then
collect the oldest wave, scatter its outputs back to the requests it carried
and refill.  While a wave executes on device, the host is coalescing and
padding the next ones — continuous micro-batching.  With
``server.max_inflight == 1`` the pump degenerates to the synchronous
dispatch/collect sequence, bit-identically.

Decode is the engine's job (``collect``), so results arrive here already in
their final dtype — including zero-row requests, which retire with the
engine's ``empty_result()`` instead of a locally fabricated array.

Concurrency contract: ``submit``/``submit_parties`` are safe from any number
of producer threads (a fleet cell's normal case — serving/fleet.py fans
requests in from the router while the cell drains); ``drain`` is single-
consumer — one drainer per queue at a time.  A failure inside the pump is
surfaced as :class:`PoisonedWaveError` carrying the ids of the requests
whose rows were in the failing wave, so a front door can quarantine the
poisoner instead of wedging the whole cell on a retry loop.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Any

import numpy as np

from repro_torch.observability import registry as telemetry
from repro_torch.observability import trace as tracing
from repro_torch.serving.engine import ModelServer


class PoisonedWaveError(RuntimeError):
    """A wave failed inside the pump — binning, dispatch, or collect.

    ``rids`` are the ids of the requests whose rows were implicated:
    exactly one for a binning (``_prep``) failure, every request coalesced
    into the wave for a dispatch/collect failure (``stage`` says which).
    The original exception rides on ``__cause__``.  Rows already rolled
    back to re-dispatchable when this propagates — a retry drain serves
    everything that is still pending.  ``partial`` holds the results of
    requests that RETIRED before the failure (they are no longer pending,
    so a caller that drops ``partial`` drops their answers)."""

    def __init__(self, msg: str, *, rids, stage: str):
        super().__init__(msg)
        self.rids = tuple(rids)
        self.stage = stage
        self.partial: dict = {}


@dataclasses.dataclass
class _Pending:
    rid: int
    x: np.ndarray               # raw (n, F) rows, or binned (M, n, Fp)
    binned: bool
    t_submit: float
    sent: int = 0               # rows dispatched into in-flight waves
    done: int = 0               # rows collected + scattered back
    out: np.ndarray | None = None
    wait: Any = None            # open ``queue.wait`` span, until dispatch

    @property
    def n_rows(self) -> int:
        return int(self.x.shape[1] if self.binned else self.x.shape[0])

    def party_rows(self, server: ModelServer, start: int,
                   take: int) -> np.ndarray:
        """(M, take, Fp) party rows for one span — raw requests bin HERE,
        inside the pump, so binning of wave i+1 overlaps device execution
        of wave i instead of serializing at submit time."""
        if self.binned:
            return self.x[:, start:start + take]
        with tracing.TRACER.span("queue.bin", rows=take):
            return server._prep(self.x[start:start + take])


class RequestQueue:
    """FIFO queue of prediction requests over one serving engine.

    ``submit`` is multi-producer thread-safe; ``drain`` is the single
    pump thread by contract (the `_Pending` objects it mutates in place —
    sent/done/out row spans — are only ever touched by that one drainer).

    Lock discipline:
        _lock: _pending, _next_id, request_stats
    """

    def __init__(self, server: ModelServer, max_wave_rows: int | None = None):
        self.server = server
        self.max_wave_rows = max_wave_rows or server.buckets[-1]
        self._pending: list[_Pending] = []
        self._next_id = 0
        # multi-producer seam: submit() from concurrent threads must not
        # interleave partially (rid allocation, the width-binding check in
        # _check_fp, and the enqueue are one atomic step); drain's structural
        # mutations of _pending take the same lock
        self._lock = threading.Lock()
        # bounded, like the server's wave_stats: no per-request leak
        self.request_stats: collections.deque = collections.deque(maxlen=4096)
        # bound once; _retire runs per drained request
        self._m_requests = telemetry.REGISTRY.counter("serving.requests")
        self._m_req_latency = telemetry.REGISTRY.histogram(
            "serving.request_latency_s")
        self._m_depth = telemetry.REGISTRY.gauge("serving.queue_depth_rows")

    def submit(self, x: np.ndarray, *, binned: bool = False) -> int:
        """Enqueue one request; returns its id (resolved by drain()).

        Raw requests are NOT binned here — binning happens span-by-span in
        the drain pump, overlapped with in-flight device execution.  Binned
        requests are shape-validated up front, so one bad request can't
        poison the pump for everything queued behind it.  Thread-safe."""
        x = np.asarray(x)
        with self._lock:
            if binned:
                if x.ndim != 3 or x.shape[0] != self.server.n_parties:
                    raise ValueError(
                        f"binned request must be ({self.server.n_parties}, "
                        f"rows, Fp), got {x.shape}")
                self.server._check_fp(x.shape[2])
            p = _Pending(self._next_id, x, bool(binned), time.perf_counter())
            p.wait = tracing.TRACER.begin("queue.wait", rows=p.n_rows)
            self._pending.append(p)
            self._next_id += 1
            return p.rid

    def submit_parties(self, blocks, *, salt=None):
        """Enqueue one request arriving as per-party blocks keyed by sample
        IDs (PartyBlocks/DataSources, matched to fit-time parties by name;
        rows may be shuffled or superset — they are re-aligned on hashed IDs
        and non-common rows dropped before the rows enter the pump).

        Returns ``(request_id, ids)``: ``drain()[request_id]`` rows line up
        with ``ids`` (the canonical aligned ordering).  Alignment + binning
        happen at submit time — the request must be pinned to an ID ordering
        before its rows can coalesce into waves."""
        from repro_torch.core import crypto
        if self.server.partition is None:
            raise ValueError("party-block requests need the fit-time "
                             "VerticalPartition bound to the server")
        ids, xb = self.server.partition.bin_party_blocks(
            blocks, salt=salt if salt is not None else crypto.DEFAULT_SALT)
        return self.submit(xb, binned=True), ids

    # -------------------------------------------------------- bulkhead seams
    def pending_rows(self) -> int:
        """Rows accepted but not yet fully served — the queue-depth a
        bulkhead sheds on (serving/fleet.py's admission check)."""
        with self._lock:
            return sum(p.n_rows - p.done for p in self._pending)

    def pending_requests(self) -> int:
        with self._lock:
            return len(self._pending)

    def evict(self, rid: int) -> np.ndarray | None:
        """Remove a pending request from the queue (dead-lettering a
        poisoner, or re-routing off a drained cell).  Returns the request
        payload (raw or binned, as submitted) or None if the rid is not
        pending.  Must not be called while a drain is mid-pump."""
        with self._lock:
            for i, p in enumerate(self._pending):
                if p.rid == rid:
                    del self._pending[i]
                    return p.x
        return None

    # ------------------------------------------------------------- the pump
    def _next_wave(self):
        """Coalesce the next wave across request boundaries (host phase).

        Returns ((M, rows, Fp) array, [(pending, start, take), ...]) or
        (None, None) when every pending row is already in flight.  A
        binning failure is attributed to the exact request being binned."""
        cap = min(self.max_wave_rows, self.server.buckets[-1])
        wave, spans, rows = [], [], 0
        with self._lock:
            pending = list(self._pending)
        for p in pending:
            remaining = p.n_rows - p.sent
            if remaining == 0:          # fully dispatched (or zero-row)
                continue
            take = min(remaining, cap - rows)
            if take == 0:               # wave is full
                break
            try:
                wave.append(p.party_rows(self.server, p.sent, take))
            except Exception as err:
                raise PoisonedWaveError(
                    f"request {p.rid} failed to bin: {err}",
                    rids=(p.rid,), stage="bin") from err
            spans.append((p, p.sent, take))
            p.sent += take
            rows += take
        if not wave:
            return None, None
        return np.concatenate(wave, axis=1), spans

    def _scatter(self, out: np.ndarray, spans) -> None:
        """Write one collected wave's (decoded) rows back to its requests."""
        lo = 0
        for p, start, take in spans:
            seg = out[lo:lo + take]
            if p.out is None:
                p.out = np.empty(p.n_rows, seg.dtype)
            p.out[start:start + take] = seg
            p.done += take
            lo += take

    def _retire(self, results: dict[int, np.ndarray]) -> None:
        with self._lock:
            still = []
            for p in self._pending:
                if p.done == p.n_rows:
                    if p.out is None:   # zero-row request: engine dtype
                        p.out = self.server.empty_result()
                    tracing.TRACER.finish(p.wait)   # never dispatched
                    results[p.rid] = p.out
                    latency = time.perf_counter() - p.t_submit
                    self.request_stats.append({
                        "rid": p.rid, "rows": int(p.done),
                        "latency_s": latency})
                    self._m_requests.inc()
                    self._m_req_latency.observe(latency)
                else:
                    still.append(p)
            self._pending = still

    def drain(self) -> dict[int, np.ndarray]:
        """Serve everything pending; returns {request_id: predictions}.

        Two-phase pump: (1) fill the in-flight ring with coalesced waves —
        each ``dispatch_wave`` returns without blocking; (2) collect the
        oldest wave, scatter its rows, retire finished requests, refill.
        The ring bound (``server.max_inflight``) is the backpressure: at
        most K waves of host memory + device work are ever outstanding.

        A failure anywhere in the pump propagates as
        :class:`PoisonedWaveError` naming the implicated request ids, with
        every dispatched-but-unserved row rolled back to re-dispatchable —
        nothing is stranded, nothing is silently dropped."""
        results: dict[int, np.ndarray] = {}
        ring: collections.deque = collections.deque()
        k = self.server.max_inflight
        with tracing.TRACER.span("queue.drain") as drain_span:
            try:
                while True:
                    while len(ring) < k:            # phase 1: fill
                        wave, spans = self._next_wave()
                        if wave is None:
                            break
                        for p, start, _ in spans:   # first rows: wait ends
                            if start == 0:
                                tracing.TRACER.finish(p.wait)
                                p.wait = None
                        try:
                            handle = self.server.dispatch_wave(wave)
                        except Exception as err:
                            raise PoisonedWaveError(
                                f"wave of requests "
                                f"{[p.rid for p, _, _ in spans]} failed to "
                                f"dispatch: {err}",
                                rids=[p.rid for p, _, _ in spans],
                                stage="dispatch") from err
                        ring.append((handle, spans))
                    if not ring:                    # nothing in flight:
                        self._retire(results)       # zero-row stragglers
                        break
                    handle, spans = ring.popleft()  # phase 2: collect
                    try:
                        out = self.server.collect(handle)
                    except Exception as err:
                        raise PoisonedWaveError(
                            f"wave of requests "
                            f"{[p.rid for p, _, _ in spans]} failed to "
                            f"collect: {err}",
                            rids=[p.rid for p, _, _ in spans],
                            stage="collect") from err
                    self._scatter(out, spans)
                    self._retire(results)
            except BaseException as err:
                # a failed dispatch/collect discards the local ring: drain
                # the already-launched waves (keeps the server's in-flight
                # counter honest) and make dispatched-but-unserved rows
                # eligible for re-dispatch, or the next drain() silently
                # strands them
                self.server.abandon(handle for handle, _ in ring)
                with self._lock:
                    for p in self._pending:
                        p.sent = p.done
                if isinstance(err, PoisonedWaveError):
                    # requests retired before the failure are no longer
                    # pending; their answers ride out on the error
                    err.partial = dict(results)
                raise
            finally:
                drain_span.set(requests=len(results))
                self._m_depth.set(self.pending_rows())
        return results
