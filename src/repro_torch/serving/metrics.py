"""Fleet observability: per-cell wave stats rolled up into FleetMetrics.

A serving fleet (serving/fleet.py) is only operable if one surface answers
"is the fleet healthy and how close to the edge is it?"  This module is that
surface:

  * :class:`CellStats`   — one cell's snapshot: wave counts, latency
    percentiles, queue depth (the bulkhead's fill level), degraded waves,
    party-sum payload bytes, compile count, and the cell's routing state.
  * :class:`FleetMetrics`— the fleet rollup: latency percentiles pooled over
    every cell's raw per-wave latencies (not an average of averages),
    throughput over the union of busy intervals across cells (concurrent
    cells overlap by design — summing per-cell rows/s would double-count
    idle time), plus the front-door counters: accepted / shed (by reason) /
    dead-lettered / re-routed.
  * :class:`AlertThresholds` + :func:`alerts` — configurable trip wires
    (p99 latency, queue depth, shed and dead-letter counts, cells down)
    evaluated against a snapshot; returns human-readable alert lines.

Cells that have served nothing yet aggregate cleanly: ``ModelServer.stats``
returns a well-formed zero record, and pooled percentiles simply skip empty
cells.  ``ServingFleet.metrics()`` builds these; a periodic snapshot hook
(``snapshot_hook=``/``snapshot_every_s=``) pushes them to whatever sink the
deployment uses (a print, a log shipper, a TSDB writer).
"""
from __future__ import annotations

import dataclasses

import numpy as np


def busy_seconds(spans) -> float:
    """Union length of [t0, t1) wave intervals — the honest denominator for
    throughput when waves overlap (async rings, concurrent cells)."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def _percentiles(latencies_s) -> tuple[float, float, float]:
    if len(latencies_s) == 0:
        return 0.0, 0.0, 0.0
    lat = np.asarray(latencies_s, float)
    p50, p95, p99 = np.percentile(lat, (50, 95, 99))
    return float(p50 * 1e3), float(p95 * 1e3), float(p99 * 1e3)


@dataclasses.dataclass(frozen=True)
class CellStats:
    """One cell's observability snapshot (derived, not live state)."""

    name: str
    state: str                   # "up" | "draining" | "down"
    waves: int
    rows: int
    p50_ms: float
    p95_ms: float
    p99_ms: float
    rows_per_s: float
    queue_depth_rows: int        # bulkhead fill: accepted, not yet served
    queue_depth_requests: int
    degraded_waves: int          # waves answered from surviving trees
    comm_bytes: int              # party-sum payload over recorded waves
    compile_count: int


@dataclasses.dataclass(frozen=True)
class FleetMetrics:
    """Fleet-level rollup of every cell plus the front-door counters."""

    cells: tuple[CellStats, ...]
    waves: int
    rows: int
    rows_per_s: float            # pooled busy-interval throughput
    p50_ms: float                # percentiles over POOLED wave latencies
    p95_ms: float
    p99_ms: float
    queue_depth_rows: int
    accepted: int
    shed: dict                   # reason -> count ("rate_limit", "queue_depth")
    dead_letters: int
    rerouted: int                # accepted requests moved off a drained cell
    degraded_waves: int
    comm_bytes: int
    cells_up: int
    cells_down: int

    @property
    def shed_total(self) -> int:
        return sum(self.shed.values())


def cell_stats(name: str, state: str, server, queue) -> CellStats:
    """Snapshot one cell from its engine + queue (zero-wave cells produce a
    well-formed zero record — ModelServer.stats guarantees the shape)."""
    s = server.stats()
    return CellStats(
        name=name, state=state, waves=s["waves"], rows=s["rows"],
        p50_ms=s["p50_ms"], p95_ms=s["p95_ms"], p99_ms=s["p99_ms"],
        rows_per_s=s["rows_per_s"],
        queue_depth_rows=queue.pending_rows(),
        queue_depth_requests=queue.pending_requests(),
        degraded_waves=sum(1 for w in server.wave_stats if w.get("degraded")),
        comm_bytes=s["comm_bytes_total"], compile_count=s["compile_count"])


def aggregate(cells, *, accepted: int, shed: dict, dead_letters: int,
              rerouted: int) -> FleetMetrics:
    """Roll per-cell (CellStats, wave_stats) pairs up into FleetMetrics.

    ``cells`` is a sequence of (CellStats, wave_stats-iterable) so the
    percentiles and the busy-interval union come from the raw per-wave
    records, not from already-reduced per-cell summaries."""
    stats = tuple(cs for cs, _ in cells)
    waves = [w for _, ws in cells for w in ws]
    p50, p95, p99 = _percentiles([w["latency_s"] for w in waves])
    busy = busy_seconds((w["t0"], w["t0"] + w["latency_s"]) for w in waves)
    rows = sum(w["n_rows"] for w in waves)
    return FleetMetrics(
        cells=stats,
        waves=len(waves), rows=rows,
        rows_per_s=rows / max(busy, 1e-12) if waves else 0.0,
        p50_ms=p50, p95_ms=p95, p99_ms=p99,
        queue_depth_rows=sum(c.queue_depth_rows for c in stats),
        accepted=accepted, shed=dict(shed), dead_letters=dead_letters,
        rerouted=rerouted,
        degraded_waves=sum(c.degraded_waves for c in stats),
        comm_bytes=sum(c.comm_bytes for c in stats),
        cells_up=sum(1 for c in stats if c.state == "up"),
        cells_down=sum(1 for c in stats if c.state == "down"))


@dataclasses.dataclass(frozen=True)
class AlertThresholds:
    """Trip wires for :func:`alerts`; None disables a check."""

    p99_ms: float | None = None
    queue_depth_rows: int | None = None
    shed_total: int | None = None
    dead_letters: int | None = None
    cells_down: int | None = 1      # any down cell alerts by default


def alerts(m: FleetMetrics,
           t: AlertThresholds = AlertThresholds()) -> list[str]:
    """Evaluate a snapshot against thresholds; one line per tripped wire."""
    out = []
    if t.p99_ms is not None and m.p99_ms > t.p99_ms:
        out.append(f"p99 latency {m.p99_ms:.1f}ms > {t.p99_ms:.1f}ms")
    if t.queue_depth_rows is not None \
            and m.queue_depth_rows > t.queue_depth_rows:
        out.append(f"queue depth {m.queue_depth_rows} rows > "
                   f"{t.queue_depth_rows}")
    if t.shed_total is not None and m.shed_total > t.shed_total:
        out.append(f"shed {m.shed_total} requests "
                   f"({', '.join(f'{k}={v}' for k, v in sorted(m.shed.items()))})")
    if t.dead_letters is not None and m.dead_letters > t.dead_letters:
        out.append(f"{m.dead_letters} dead-lettered requests")
    if t.cells_down is not None and m.cells_down >= t.cells_down:
        down = [c.name for c in m.cells if c.state == "down"]
        out.append(f"{m.cells_down} cells down ({', '.join(down)})")
    return out
