"""Serving-fleet smoke: mixed traffic, overload shedding, and a cell kill.

Stands up a 4-cell :class:`ServingFleet` over one fitted forest via
``Federation.serve_fleet`` — on the CUDA card, or with ``--device cpu`` on
the CPU — and drives it through the failure modes the front
door exists for:

  1. mixed small-request traffic routed by consistent hashing, drained
     concurrently across cells — every request's predictions asserted
     bit-identical to a single ModelServer serving the same rows;
  2. forced overload — a starved token bucket and tiny bulkheads — with
     both typed ``FleetOverloadError`` shed paths observed and counted;
  3. an injected cell kill with requests pending: the dead cell's keyspace
     redistributes to the survivors and ZERO accepted requests are lost
     (every accepted rid resolves or dead-letters, asserted).

The fleet subsystem's end-to-end check::

    PYTHONPATH=src python -m repro_torch.launch.fleet_demo [--device cpu]

Exit code 0 means: routing bit-identity held, both shed paths tripped
typed, the kill lost nothing, and the FleetMetrics/alert surface saw it all.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.core import ForestParams
from repro_torch.data import make_classification
from repro_torch.federation import Federation
from repro_torch.serving import (AlertThresholds, FleetOverloadError, ServeConfig,
                           ServingFleet, alerts)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", type=int, default=4)
    ap.add_argument("--parties", type=int, default=3)
    ap.add_argument("--trees", type=int, default=4)
    ap.add_argument("--depth", type=int, default=6)
    ap.add_argument("--rows", type=int, default=900)
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    p = ForestParams(n_estimators=args.trees, max_depth=args.depth,
                     n_bins=16, seed=0)
    x, y = make_classification(args.rows, 18, 2, seed=0)
    fed = Federation(parties=args.parties, n_bins=p.n_bins,
                     device=args.device)
    fed.ingest(x[:args.rows - 200], y[:args.rows - 200])
    model = fed.fit(p)
    xt = x[args.rows - 200:]

    t0 = time.time()
    cfg = ServeConfig(buckets=(32, 128))
    snapshots: list = []
    fleet = fed.serve_fleet(model, cfg, n_cells=args.cells,
                            snapshot_hook=snapshots.append).warmup()
    single = fed.serve(model, cfg)
    print(f"fleet: {args.cells} cells x {len(cfg.buckets)} bucket "
          f"programs compiled in {time.time() - t0:.1f}s")

    # ---- 1. mixed traffic, bit-identity against the single server
    rng = np.random.default_rng(1)
    rids = {}
    for i in range(args.requests):
        chunk = xt[rng.integers(0, len(xt), size=int(rng.integers(1, 64)))]
        rids[fleet.submit(chunk, key=f"req-{i}")] = chunk
    results = fleet.drain()
    assert set(results) == set(rids), "drain lost requests"
    for rid, chunk in rids.items():
        assert np.array_equal(results[rid], single.serve(chunk)), \
            f"request {rid} diverged from the single-server oracle"
    spread = {name: cell.server.stats()["rows"]
              for name, cell in fleet.cells.items()}
    print(f"traffic: {len(rids)} requests bit-identical; "
          f"rows per cell {spread}")

    # ---- 2. forced overload: both typed shed paths
    servers = [cell.server for cell in fleet.cells.values()]
    limited = ServingFleet({f"r{i}": s for i, s in enumerate(servers)},
                           rate_limit_rows_per_s=1.0, rate_burst=80.0)
    shed = {"rate_limit": 0, "queue_depth": 0}
    for i in range(12):
        try:
            limited.submit(xt[:40], key=f"ovl-{i}")
        except FleetOverloadError as err:
            assert err.reason == "rate_limit"
            shed["rate_limit"] += 1
    limited.drain()
    bulk = ServingFleet({f"q{i}": s for i, s in enumerate(servers)},
                        max_queue_rows=64)
    for i in range(8 * args.cells):
        try:
            bulk.submit(xt[:60], key=f"jam-{i}")
        except FleetOverloadError as err:
            assert err.reason == "queue_depth" and err.cell
            shed["queue_depth"] += 1
    bulk.drain()
    assert shed["rate_limit"] > 0 and shed["queue_depth"] > 0, shed
    assert limited.metrics().shed["rate_limit"] == shed["rate_limit"]
    print(f"overload: shed {shed['rate_limit']} on rate limit, "
          f"{shed['queue_depth']} on queue depth — typed, counted")

    # ---- 3. cell kill with pending traffic: zero lost accepted requests
    before = fleet.accepted_count
    rids2 = {}
    for i in range(args.requests):
        chunk = xt[rng.integers(0, len(xt), size=int(rng.integers(1, 64)))]
        rids2[fleet.submit(chunk, key=f"phase2-{i}")] = chunk
    victim = max(fleet.cells_up(),
                 key=lambda n: fleet.cells[n].queue.pending_requests())
    moved = fleet.kill_cell(victim)
    results2 = fleet.drain()
    accepted = fleet.accepted_count - before
    resolved = set(results2)
    dead = {d.rid for d in fleet.dead_letters}
    assert resolved | dead == set(rids2), "accepted requests were lost!"
    assert len(resolved) + len(dead) == accepted == len(rids2)
    for rid, chunk in rids2.items():
        assert np.array_equal(results2[rid], single.serve(chunk)), \
            f"post-kill request {rid} diverged"
    m = fleet.metrics()
    fired = alerts(m, AlertThresholds(cells_down=1))
    assert m.cells_down == 1 and m.rerouted == moved and fired
    print(f"kill: cell {victim} down with {moved} requests pending -> "
          f"re-routed, {len(resolved)}/{accepted} resolved, "
          f"{len(dead)} dead-lettered, zero lost")
    print(f"metrics: rows={m.rows} p50={m.p50_ms:.2f}ms p99={m.p99_ms:.2f}ms "
          f"accepted={m.accepted} shed={m.shed_total} cells_up={m.cells_up}")
    print(f"alerts: {'; '.join(fired)}")
    assert snapshots, "snapshot hook never fired"
    print("ALL OK")


if __name__ == "__main__":
    main()
