"""Cell-based serving fleet: sharded replicas behind one admission front door.

One ``ModelServer`` is compile-once but single-replica: one wave ring, one
queue, one failure domain.  ``ServingFleet`` owns N replicated server
**cells** — each with its own compiled programs (a CUDA graph per bucket
on the card) and CUDA stream, its own bounded
:class:`RequestQueue` acting as a bulkhead, and its own in-flight ring — and
puts a real front door ahead of them:

  * **Routing** — consistent hashing on the request key (default: the fleet
    request id; pass stable sample/request IDs for sticky routing).  Each
    cell projects ``vnodes`` points onto a hash ring; a key routes to the
    next point clockwise.  Adding or removing a cell re-routes only the
    keyspace adjacent to that cell's points — a fleet resize does NOT
    reshuffle the whole keyspace (asserted in tests/test_torch_fleet.py).
  * **Admission control** — a token-bucket rate limiter (rows per second,
    burst capacity) at the front door, and per-cell queue-depth shedding:
    a request that would overflow its cell's bulkhead is rejected with a
    typed :class:`FleetOverloadError` naming the reason and cell, never
    silently dropped or allowed to wedge a neighbour cell.
  * **Poison quarantine** — a request that fails inside a cell's pump
    (binning, dispatch, or collect — e.g. the engine's width/rank guards)
    is quarantined and retried SOLO, so attribution is exact; after
    ``max_poison_retries`` solo failures it lands in the **dead-letter
    sink** with its payload and the error, and the cell keeps serving
    everyone else.
  * **Cell failure** — ``kill_cell`` (or a failed health check via
    ``check_health``, reusing the distributed substrate's ``health()``
    machinery) drains a cell: it leaves the ring, and every accepted,
    unresolved request it held is re-routed to the surviving keyspace.
    Accepted requests are never lost: each one resolves, re-routes, or
    dead-letters — asserted end-to-end in tests and launch/fleet_demo.py.

Observability is serving/metrics.py: ``metrics()`` pools every cell's raw
wave latencies into fleet percentiles and busy-interval throughput, and the
snapshot hook (``snapshot_hook=``, ``snapshot_every_s=``) pushes periodic
:class:`FleetMetrics` to the deployment's sink.

Build fleets through ``Federation.serve_fleet(model, config, n_cells=...)``
— it replicates the session's serving engine per cell with the same
cache/refresh semantics as ``Federation.serve``.
"""
from __future__ import annotations

import bisect
import dataclasses
import hashlib
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable

import numpy as np

from repro_torch.federation.transport import PartyUnavailableError
from repro_torch.observability import registry as telemetry
from repro_torch.observability import trace as tracing
from repro_torch.serving import metrics as fleet_metrics
from repro_torch.serving.engine import ModelServer
from repro_torch.serving.queue import PoisonedWaveError, RequestQueue


class FleetOverloadError(RuntimeError):
    """Typed admission rejection — the caller should back off and retry.

    ``reason`` is ``"rate_limit"`` (the front-door token bucket is empty) or
    ``"queue_depth"`` (the routed cell's bulkhead is full; ``cell`` names
    it).  Shed requests are counted in the fleet metrics, never enqueued."""

    def __init__(self, msg: str, *, reason: str, cell: str | None = None):
        super().__init__(msg)
        self.reason = reason
        self.cell = cell


class TokenBucket:
    """Token-bucket rate limiter (tokens = rows; refill = rate per second).

    ``clock`` is injectable so tests drive time deterministically.

    Lock discipline:
        _lock: _tokens, _t
    """

    def __init__(self, rate: float, capacity: float | None = None,
                 clock: Callable[[], float] = time.monotonic):
        if rate <= 0:
            raise ValueError(f"rate must be > 0, got {rate}")
        self.rate = float(rate)
        self.capacity = float(capacity if capacity is not None else rate)
        self._tokens = self.capacity
        self._clock = clock
        self._t = clock()
        self._lock = threading.Lock()

    def try_acquire(self, n: float = 1.0) -> bool:
        with self._lock:
            now = self._clock()
            self._tokens = min(self.capacity,
                               self._tokens + (now - self._t) * self.rate)
            self._t = now
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False


def _hash64(key: str) -> int:
    return int.from_bytes(
        hashlib.blake2b(key.encode(), digest_size=8).digest(), "big")


class HashRing:
    """Consistent-hash ring over named cells (``vnodes`` points per cell).

    Stability contract: removing a cell re-routes ONLY keys that routed to
    that cell; adding one steals only the keyspace adjacent to its points."""

    def __init__(self, vnodes: int = 64):
        self.vnodes = int(vnodes)
        self._points: list[int] = []        # sorted hash points
        self._owner: dict[int, str] = {}    # point -> cell name

    def add(self, name: str) -> None:
        for v in range(self.vnodes):
            h = _hash64(f"{name}#{v}")
            while h in self._owner:         # vanishing-probability collision
                h = (h + 1) & (2**64 - 1)
            self._owner[h] = name
            bisect.insort(self._points, h)

    def remove(self, name: str) -> None:
        dead = [p for p, n in self._owner.items() if n == name]
        for p in dead:
            del self._owner[p]
        self._points = sorted(self._owner)

    def route(self, key: str) -> str:
        if not self._points:
            raise RuntimeError("hash ring is empty: no cells up")
        i = bisect.bisect(self._points, _hash64(key)) % len(self._points)
        return self._owner[self._points[i]]

    def __contains__(self, name: str) -> bool:
        return any(n == name for n in self._owner.values())

    def __len__(self) -> int:
        return len(set(self._owner.values()))


@dataclasses.dataclass
class _FleetRequest:
    """Front-door record of one accepted request (until resolved)."""

    rid: int
    key: str
    x: Any                       # payload as admitted (raw rows or binned)
    binned: bool
    cell: str
    cell_rid: int
    poisons: int = 0


@dataclasses.dataclass
class DeadLetter:
    """A request that repeatedly poisoned waves — parked, not dropped."""

    rid: int
    key: str
    x: Any
    error: Exception
    poisons: int


class _Cell:
    """One replica: engine + bounded queue (the bulkhead) + routing state."""

    def __init__(self, name: str, server: ModelServer, max_queue_rows: int):
        self.name = name
        self.server = server
        self.queue = RequestQueue(server)
        self.max_queue_rows = int(max_queue_rows)
        self.state = "up"                    # up | down


class ServingFleet:
    """N server cells behind consistent-hash routing and admission control.

    Args:
      servers: the cell engines (one compiled replica per cell), or a
        ``{name: server}`` mapping; a sequence gets ``cell0..cellN-1``.
      max_queue_rows: per-cell bulkhead — accepted-but-unserved rows beyond
        this shed with ``FleetOverloadError(reason="queue_depth")``.
      rate_limit_rows_per_s / rate_burst: front-door token bucket (None
        disables rate limiting).
      max_poison_retries: solo retries before a poisoning request is
        dead-lettered.
      vnodes: hash-ring points per cell (routing granularity).
      snapshot_hook / snapshot_every_s: periodic observability push — after
        a drain, if ``snapshot_every_s`` elapsed since the last push, the
        hook is called with a fresh :class:`FleetMetrics`.
      clock: injectable time source for the rate limiter and snapshots.

    Concurrency: ``submit``/``submit_parties`` are thread-safe (the cell
    queues are multi-producer).  ``drain``, ``kill_cell`` and
    ``check_health`` are coordinator operations — call them from one
    thread (drain itself fans out over the cells internally).

    Lock discipline:
        _lock: _requests, _by_cell_rid, _next_rid, accepted_count, shed_counts
        unsynchronized (coordinator thread only, per the contract above): dead_letters, rerouted_count
        unsynchronized (coordinator thread only): ring, _last_snapshot
    """

    def __init__(self, servers, *, max_queue_rows: int = 8192,
                 rate_limit_rows_per_s: float | None = None,
                 rate_burst: float | None = None,
                 max_poison_retries: int = 2, vnodes: int = 64,
                 snapshot_hook: Callable | None = None,
                 snapshot_every_s: float | None = None,
                 clock: Callable[[], float] = time.monotonic):
        named = (dict(servers) if isinstance(servers, dict) else
                 {f"cell{i}": s for i, s in enumerate(servers)})
        if not named:
            raise ValueError("a fleet needs at least one cell")
        self.cells: dict[str, _Cell] = {
            name: _Cell(name, server, max_queue_rows)
            for name, server in named.items()}
        self.ring = HashRing(vnodes=vnodes)
        for name in self.cells:
            self.ring.add(name)
        self.limiter = (TokenBucket(rate_limit_rows_per_s, rate_burst,
                                    clock=clock)
                        if rate_limit_rows_per_s is not None else None)
        self.max_poison_retries = int(max_poison_retries)
        self.dead_letters: list[DeadLetter] = []
        self.accepted_count = 0
        self.shed_counts: dict[str, int] = {"rate_limit": 0, "queue_depth": 0}
        self.rerouted_count = 0
        self._requests: dict[int, _FleetRequest] = {}   # unresolved
        self._by_cell_rid: dict[tuple[str, int], int] = {}
        self._next_rid = 0
        self._lock = threading.Lock()
        self._snapshot_hook = snapshot_hook
        self._snapshot_every_s = snapshot_every_s
        self._clock = clock
        self._last_snapshot = clock()

    # ------------------------------------------------------------ admission
    def _admit(self, key: str, n_rows: int) -> _Cell:
        """Front door: rate limit, route, bulkhead check.  Raises
        FleetOverloadError instead of enqueueing when overloaded."""
        if self.limiter is not None and n_rows > 0 \
                and not self.limiter.try_acquire(n_rows):
            with self._lock:        # submit is multi-producer
                self.shed_counts["rate_limit"] += 1
            raise FleetOverloadError(
                f"rate limit: {n_rows} rows rejected at the front door",
                reason="rate_limit")
        cell = self.cells[self.ring.route(key)]
        depth = cell.queue.pending_rows()
        if depth + n_rows > cell.max_queue_rows:
            with self._lock:
                self.shed_counts["queue_depth"] += 1
            raise FleetOverloadError(
                f"cell {cell.name} bulkhead full: {depth} pending rows "
                f"+ {n_rows} > {cell.max_queue_rows}",
                reason="queue_depth", cell=cell.name)
        return cell

    def _record(self, key: str, x, binned: bool, cell: _Cell,
                cell_rid: int) -> int:
        with self._lock:
            rid = self._next_rid
            self._next_rid += 1
            self._requests[rid] = _FleetRequest(
                rid=rid, key=key, x=x, binned=binned, cell=cell.name,
                cell_rid=cell_rid)
            self._by_cell_rid[(cell.name, cell_rid)] = rid
            self.accepted_count += 1
        return rid

    def submit(self, x: np.ndarray, *, key: str | None = None,
               binned: bool = False) -> int:
        """Admit one request; returns the fleet request id (resolved by
        ``drain``).  ``key`` is the routing key — stable IDs give sticky
        routing; default is the fleet rid (uniform spread)."""
        x = np.asarray(x)
        n = int(x.shape[1] if binned else x.shape[0])
        with self._lock:
            key = key if key is not None else f"req-{self._next_rid}"
        cell = self._admit(key, n)
        cell_rid = cell.queue.submit(x, binned=binned)
        return self._record(key, x, binned, cell, cell_rid)

    def submit_parties(self, blocks, *, key: str | None = None, salt=None):
        """Per-party request blocks through the same front door: the routed
        cell's fit-time partition re-aligns them on hashed IDs, then the
        aligned rows are admitted (rate limit + bulkhead) as a binned
        request.  Returns ``(rid, ids)`` — ``drain()[rid]`` rows line up
        with ``ids``."""
        from repro_torch.core import crypto
        any_cell = next(iter(self.cells.values()))
        if any_cell.server.partition is None:
            raise ValueError("party-block serving needs the fit-time "
                             "VerticalPartition bound to the cell servers")
        ids, xb = any_cell.server.partition.bin_party_blocks(
            blocks, salt=salt if salt is not None else crypto.DEFAULT_SALT)
        return self.submit(xb, key=key, binned=True), ids

    def serve(self, x: np.ndarray, *, key: str | None = None) -> np.ndarray:
        """Admit + drain one request (the synchronous convenience path)."""
        rid = self.submit(x, key=key)
        return self.drain()[rid]

    # ---------------------------------------------------------------- drain
    def drain(self) -> dict[int, np.ndarray]:
        """Serve every accepted pending request; returns {rid: predictions}.

        Cells drain concurrently (one thread per cell — each pumps its own
        bounded in-flight ring).  Poisoned waves quarantine and solo-retry
        the implicated requests; a cell that fails wholesale (its substrate
        reports parties unavailable beyond what degraded serving covers) is
        drained and its requests re-route.  Every accepted request ends in
        the results dict or the dead-letter sink — never silently lost."""
        results: dict[int, np.ndarray] = {}
        with tracing.TRACER.span("fleet.drain", category="host",
                                 cells=len(self.cells)):
            for _ in range(8 * max(1, len(self.cells))):  # progress-bounded
                active = [c for c in self.cells.values()
                          if c.state == "up" and c.queue.pending_requests()]
                if not active:
                    break
                if len(active) == 1:
                    outcomes = {active[0].name: self._drain_cell(active[0])}
                else:
                    with ThreadPoolExecutor(max_workers=len(active)) as pool:
                        futs = {c.name: pool.submit(self._drain_cell, c)
                                for c in active}
                        outcomes = {n: f.result() for n, f in futs.items()}
                for name, outcome in outcomes.items():
                    self._absorb(self.cells[name], outcome, results)
        self._publish_telemetry()
        self._maybe_snapshot()
        return results

    def _publish_telemetry(self) -> None:
        """Push fleet-level counters into the shared telemetry registry
        (coordinator thread, after a drain pass — reads under ``_lock``
        where the discipline map requires it)."""
        reg = telemetry.REGISTRY
        with self._lock:
            accepted = self.accepted_count
            shed = dict(self.shed_counts)
        reg.gauge("fleet.accepted").set(accepted)
        for reason, n in shed.items():
            reg.gauge(f"fleet.shed.{reason}").set(n)
        reg.gauge("fleet.dead_letters").set(len(self.dead_letters))
        reg.gauge("fleet.rerouted").set(self.rerouted_count)
        reg.gauge("fleet.cells_up").set(
            sum(1 for c in self.cells.values() if c.state == "up"))

    @staticmethod
    def _drain_cell(cell: _Cell):
        """One cell's pump pass; exceptions are data, not control flow."""
        try:
            return cell.queue.drain()
        except (PoisonedWaveError, PartyUnavailableError) as err:
            return err

    def _absorb(self, cell: _Cell, outcome, results: dict) -> None:
        """Fold one cell's drain outcome into fleet state."""
        if isinstance(outcome, dict):
            self._resolve(cell, outcome, results)
            return
        if isinstance(outcome, PoisonedWaveError):
            # requests that retired before the wave failed are done — their
            # answers ride on the error's partial dict
            self._resolve(cell, outcome.partial, results)
        # the queue wraps every pump failure in PoisonedWaveError; a party
        # lost under the cell (PartyUnavailableError on __cause__) is a CELL
        # failure — drain the cell, don't blame the request
        cause = getattr(outcome, "__cause__", None)
        if isinstance(outcome, PartyUnavailableError) \
                or isinstance(cause, PartyUnavailableError):
            self.kill_cell(cell.name)
        else:
            self._quarantine(cell, outcome, results)

    def _resolve(self, cell: _Cell, outs: dict, results: dict) -> None:
        with self._lock:
            for cell_rid, out in outs.items():
                rid = self._by_cell_rid.pop((cell.name, cell_rid), None)
                if rid is None:               # evicted/re-routed meanwhile
                    continue
                self._requests.pop(rid, None)
                results[rid] = out

    def _quarantine(self, cell: _Cell, err: PoisonedWaveError,
                    results: dict) -> None:
        """Evict the implicated requests, then retry each SOLO so the real
        poisoner is identified exactly; dead-letter past the retry budget."""
        suspects = []
        with self._lock:
            for cell_rid in err.rids:
                rid = self._by_cell_rid.pop((cell.name, cell_rid), None)
                if rid is not None:
                    suspects.append(self._requests[rid])
        for req in suspects:
            cell.queue.evict(req.cell_rid)
        for req in suspects:
            self._solo_retry(cell, req, results, err)

    def _solo_retry(self, cell: _Cell, req: _FleetRequest, results: dict,
                    last_err: Exception) -> None:
        while True:
            req.poisons += 1
            if req.poisons > self.max_poison_retries:
                with self._lock:
                    self._requests.pop(req.rid, None)
                self.dead_letters.append(DeadLetter(
                    rid=req.rid, key=req.key, x=req.x, error=last_err,
                    poisons=req.poisons))
                return
            solo = RequestQueue(cell.server)  # nothing else can coalesce in
            solo_rid = solo.submit(req.x, binned=req.binned)
            try:
                out = solo.drain()[solo_rid]
            except PoisonedWaveError as err2:
                last_err = err2
                continue
            with self._lock:
                self._requests.pop(req.rid, None)
            results[req.rid] = out
            return

    # -------------------------------------------------------- cell lifecycle
    def kill_cell(self, name: str) -> int:
        """Drain a cell out of the fleet: it leaves the ring, and every
        accepted, unresolved request it held re-routes onto the surviving
        keyspace (the consistent-hash property keeps everyone else's
        routing unchanged).  Returns the number of re-routed requests.
        Raises if this was the last cell up — a fleet of zero cells cannot
        honour its accepted requests."""
        cell = self.cells[name]
        if cell.state == "down":
            return 0
        survivors = [c for c in self.cells.values()
                     if c.state == "up" and c.name != name]
        if not survivors:
            raise RuntimeError(
                f"cannot drain {name}: it is the last cell up and accepted "
                f"requests would be lost")
        cell.state = "down"
        self.ring.remove(name)
        with self._lock:
            stranded = [r for r in self._requests.values()
                        if r.cell == name]
        moved = 0
        for req in stranded:
            cell.queue.evict(req.cell_rid)
            with self._lock:
                self._by_cell_rid.pop((name, req.cell_rid), None)
            target = self.cells[self.ring.route(req.key)]
            req.cell = target.name
            req.cell_rid = target.queue.submit(req.x, binned=req.binned)
            with self._lock:
                self._by_cell_rid[(target.name, req.cell_rid)] = req.rid
            moved += 1
        self.rerouted_count += moved
        return moved

    def check_health(self) -> dict[str, bool]:
        """Health-check every up cell through its substrate's ``health()``
        seam (the party-per-process substrate's; the in-process and sharded
        substrates have no such seam and are trivially healthy).  A cell whose substrate reports
        dead parties it cannot serve around — every party down, or any
        party down without ``allow_degraded`` — is drained via
        :meth:`kill_cell`.  Returns {cell: healthy}."""
        out: dict[str, bool] = {}
        for name, cell in list(self.cells.items()):
            if cell.state != "up":
                out[name] = False
                continue
            healthy = True
            probe = getattr(cell.server.substrate, "health", None)
            if probe is not None:
                h = probe()
                dead = [p for p, v in h.items() if v is None]
                if dead:
                    healthy = (cell.server.allow_degraded
                               and len(dead) < len(h))
            out[name] = healthy
            if not healthy:
                self.kill_cell(name)
        return out

    def cells_up(self) -> list[str]:
        return [n for n, c in self.cells.items() if c.state == "up"]

    # ---------------------------------------------------------- observability
    def metrics(self) -> fleet_metrics.FleetMetrics:
        """A fresh FleetMetrics snapshot over every cell (up or down)."""
        pairs = [(fleet_metrics.cell_stats(n, c.state, c.server, c.queue),
                  list(c.server.wave_stats))
                 for n, c in self.cells.items()]
        return fleet_metrics.aggregate(
            pairs, accepted=self.accepted_count, shed=self.shed_counts,
            dead_letters=len(self.dead_letters),
            rerouted=self.rerouted_count)

    def _maybe_snapshot(self) -> None:
        if self._snapshot_hook is None:
            return
        now = self._clock()
        if self._snapshot_every_s is None \
                or now - self._last_snapshot >= self._snapshot_every_s:
            self._last_snapshot = now
            self._snapshot_hook(self.metrics())

    # ------------------------------------------------------------- engines
    def warmup(self) -> "ServingFleet":
        """Compile (on the card: capture) every up cell's bucket
        programs."""
        for cell in self.cells.values():
            if cell.state == "up":
                cell.server.warmup()
        return self
