"""The port's serving fleet on the CPU: twins of tests/test_fleet.py —
routing, admission, poison quarantine, cell kill without loss, per-cell
autotune and metrics — plus the fleet held against the JAX package: its
consistent-hash routes equal JAX's key for key, and the fleet's answers
equal the JAX forest's ``predict`` bit for bit (same data, seed and
params).

  * **Bit-identity oracle** — whatever the routing decides, every request
    served through the fleet equals a single server serving the same rows.
  * **Zero lost accepted requests** — killing 1 of 4 cells with traffic
    pending re-routes its keyspace to the survivors; every accepted request
    resolves or dead-letters, never drops silently.
"""
import dataclasses
import threading

import numpy as np
import pytest

from repro.core.forest import FederatedForest as JForest
from repro.core.party import make_vertical_partition as j_make_partition
from repro.core.types import ForestParams as JParams
from repro.serving.fleet import HashRing as JHashRing
from repro_torch.core import ForestParams, fit_federated_forest
from repro_torch.core.partyblock import PartyBlock
from repro_torch.data import make_classification, make_party_views
from repro_torch.federation import Federation
from repro_torch.federation.transport import PartyUnavailableError
from repro_torch.serving import (AlertThresholds, FleetOverloadError,
                                 ForestServer, PoisonedWaveError,
                                 RequestQueue, ServeConfig, ServingFleet,
                                 alerts)
from repro_torch.serving.fleet import HashRing, TokenBucket
from repro_torch.serving.metrics import busy_seconds

KW = dict(n_classes=3, n_estimators=4, max_depth=6, n_bins=16, seed=1)


@pytest.fixture(scope="module")
def fleet_env():
    """One fitted forest + a 4-cell fleet + the single-server oracle."""
    x, y = make_classification(600, 18, 3, seed=0)
    fed = Federation(parties=3, n_bins=16, device="cpu")
    fed.ingest(x[:450], y[:450])
    model = fed.fit(ForestParams(**KW))
    cfg = ServeConfig(buckets=(32, 128))
    fleet = fed.serve_fleet(model, cfg, n_cells=4).warmup()
    single = fed.serve(model, cfg)
    return fed, model, cfg, fleet, single, x[450:]


# ----------------------------------------------------------- hash ring
def test_hash_ring_routes_equal_jax():
    """The port's ring is the JAX ring: the same key routes to the same
    cell, before and after a cell leaves."""
    mine, theirs = HashRing(vnodes=64), JHashRing(vnodes=64)
    for n in ("a", "b", "c", "d"):
        mine.add(n)
        theirs.add(n)
    keys = [f"k{i}" for i in range(2000)]
    assert [mine.route(k) for k in keys] == [theirs.route(k) for k in keys]
    mine.remove("b")
    theirs.remove("b")
    assert [mine.route(k) for k in keys] == [theirs.route(k) for k in keys]


def test_hash_ring_stability_under_remove():
    ring = HashRing(vnodes=64)
    for n in ("a", "b", "c", "d"):
        ring.add(n)
    keys = [f"k{i}" for i in range(3000)]
    before = {k: ring.route(k) for k in keys}
    ring.remove("c")
    moved = [k for k in keys if ring.route(k) != before[k]]
    assert moved and all(before[k] == "c" for k in moved)
    assert 0.10 < len(moved) / len(keys) < 0.45


def test_hash_ring_add_steals_only_adjacent_keyspace():
    ring = HashRing(vnodes=64)
    for n in ("a", "b", "c"):
        ring.add(n)
    keys = [f"s{i}" for i in range(3000)]
    before = {k: ring.route(k) for k in keys}
    ring.add("d")
    moved = [k for k in keys if ring.route(k) != before[k]]
    assert moved and all(ring.route(k) == "d" for k in moved)


def test_hash_ring_spreads_keys():
    ring = HashRing(vnodes=64)
    for n in ("a", "b", "c", "d"):
        ring.add(n)
    counts: dict = {}
    for i in range(4000):
        counts[ring.route(f"x{i}")] = counts.get(ring.route(f"x{i}"), 0) + 1
    assert set(counts) == {"a", "b", "c", "d"}
    assert min(counts.values()) > 200


# --------------------------------------------------------- token bucket
def test_token_bucket_refills_on_injected_clock():
    t = [0.0]
    tb = TokenBucket(rate=100.0, capacity=100.0, clock=lambda: t[0])
    assert tb.try_acquire(100) and not tb.try_acquire(1)
    t[0] = 0.25
    assert tb.try_acquire(25) and not tb.try_acquire(1)
    t[0] = 10.0
    assert tb.try_acquire(100) and not tb.try_acquire(1)


# ------------------------------------------------- bit-identity oracle
def test_fleet_bit_identity_oracle(fleet_env):
    _, _, _, fleet, single, xt = fleet_env
    rng = np.random.default_rng(0)
    rids = {}
    for i in range(16):
        chunk = xt[rng.integers(0, len(xt), size=int(rng.integers(1, 90)))]
        rids[fleet.submit(chunk, key=f"oracle-{i}")] = chunk
    out = fleet.drain()
    assert set(out) == set(rids)
    for rid, chunk in rids.items():
        np.testing.assert_array_equal(out[rid], single.serve(chunk))
    served = [c for c in fleet.cells.values()
              if c.server.stats()["rows"] > 0]
    assert len(served) > 1


def test_fleet_equals_jax_predict(fleet_env):
    """The fleet's answers == the JAX forest's predict on the same rows."""
    _, _, _, fleet, _, xt = fleet_env
    x, y = make_classification(600, 18, 3, seed=0)
    jff = JForest(JParams(**KW)).fit(j_make_partition(x[:450], 3, 16),
                                     y[:450])
    want = np.asarray(jff.predict(xt))
    spans = [(lo, lo + 1 + 7 * i) for i, lo in enumerate(range(0, 140, 14))]
    rids = {fleet.submit(xt[a:b], key=f"jax-{a}"): (a, b) for a, b in spans}
    out = fleet.drain()
    for rid, (a, b) in rids.items():
        np.testing.assert_array_equal(out[rid], want[a:b])


def test_fleet_serve_parties_through_front_door():
    x, y = make_classification(260, 9, 2, seed=10)
    blocks, _, _ = make_party_views(x, y, 3, overlap=0.85, seed=10)
    fed = Federation(parties=3, n_bins=16, device="cpu")
    part = fed.ingest(blocks)
    model = fed.fit(ForestParams(n_estimators=3, max_depth=4, n_bins=16,
                                 seed=1))
    cfg = ServeConfig(buckets=(64,))
    fleet = fed.serve_fleet(model, cfg, n_cells=2)
    single = fed.serve(model, cfg)
    xt, _ = make_classification(30, 9, 2, seed=77)
    qids = np.array([f"q{i}" for i in range(len(xt))])
    req = []
    for i, name in enumerate(part.party_names):
        gid = part.feat_gid[i][part.feat_gid[i] >= 0]
        req.append(PartyBlock(name=name, x=xt[:, gid], ids=qids))
    rid, ids = fleet.submit_parties(req, key="pb-1")
    want_ids, want = single.serve_parties(req)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(fleet.drain()[rid], want)


# --------------------------------------------- cell kill / zero loss
def test_kill_cell_mid_traffic_loses_nothing(fleet_env):
    _, _, _, fleet, single, xt = fleet_env
    rng = np.random.default_rng(1)
    before = fleet.accepted_count
    rids = {}
    for i in range(20):
        chunk = xt[rng.integers(0, len(xt), size=int(rng.integers(1, 60)))]
        rids[fleet.submit(chunk, key=f"kill-{i}")] = chunk
    assert fleet.accepted_count - before == len(rids)
    victim = max(fleet.cells_up(),
                 key=lambda n: fleet.cells[n].queue.pending_requests())
    pending = fleet.cells[victim].queue.pending_requests()
    assert pending > 0
    moved = fleet.kill_cell(victim)
    assert moved == pending
    out = fleet.drain()
    dead = {d.rid for d in fleet.dead_letters}
    assert set(out) | dead == set(rids) and not dead
    for rid, chunk in rids.items():
        np.testing.assert_array_equal(out[rid], single.serve(chunk))
    m = fleet.metrics()
    assert m.cells_down >= 1 and m.rerouted >= moved
    assert alerts(m, AlertThresholds(cells_down=1))
    for i in range(50):
        assert fleet.ring.route(f"post-{i}") != victim


def test_kill_last_cell_refused():
    x, y = make_classification(200, 8, 2, seed=3)
    ff = fit_federated_forest(x, y, 2, ForestParams(
        n_estimators=2, max_depth=4, n_bins=16, seed=0), device="cpu")
    fleet = ServingFleet([ForestServer.from_forest(ff, buckets=(32,))])
    with pytest.raises(RuntimeError, match="last cell"):
        fleet.kill_cell("cell0")


def test_health_fail_drains_cell(fleet_env):
    _, model, _, _, single, xt = fleet_env
    servers = [ForestServer.from_forest(model, buckets=(64,)).warmup()
               for _ in range(2)]
    fleet = ServingFleet({"a": servers[0], "b": servers[1]})
    rid = fleet.submit(xt[:40], key="health-1")
    victim = fleet.cells[fleet.ring.route("health-1")]
    victim.server.substrate.health = lambda: {0: None, 1: 0.01, 2: 0.01}
    health = fleet.check_health()
    assert health[victim.name] is False
    assert victim.state == "down" and victim.name not in fleet.ring
    np.testing.assert_array_equal(fleet.drain()[rid], single.serve(xt[:40]))


def test_party_failure_drains_cell_not_request(fleet_env):
    """A party lost under a cell (PartyUnavailableError inside the pump) is
    a cell failure: the cell drains and its requests re-route."""
    _, model, _, _, single, xt = fleet_env
    servers = {n: ForestServer.from_forest(model, buckets=(64,))
               for n in ("a", "b")}
    fleet = ServingFleet(servers)
    rid = fleet.submit(xt[:30], key="party-1")
    victim = fleet.cells[fleet.ring.route("party-1")]

    def lost(compiled, xbt):
        raise PartyUnavailableError("party 1 is gone", parties=(1,))
    victim.server._execute = lost
    out = fleet.drain()
    assert victim.state == "down" and not fleet.dead_letters
    np.testing.assert_array_equal(out[rid], single.serve(xt[:30]))


# ----------------------------------------------------- admission control
def test_rate_limit_sheds_typed(fleet_env):
    _, _, _, fleet, _, xt = fleet_env
    t = [0.0]
    servers = [c.server for c in fleet.cells.values()][:2]
    limited = ServingFleet({f"r{i}": s for i, s in enumerate(servers)},
                           rate_limit_rows_per_s=100.0, rate_burst=100.0,
                           clock=lambda: t[0])
    limited.submit(xt[:100], key="a")
    with pytest.raises(FleetOverloadError) as ei:
        limited.submit(xt[:5], key="b")
    assert ei.value.reason == "rate_limit"
    assert limited.shed_counts["rate_limit"] == 1
    t[0] = 1.0
    limited.submit(xt[:5], key="b")
    assert len(limited.drain()) == 2


def test_queue_depth_sheds_typed_per_cell(fleet_env):
    _, _, _, fleet, _, xt = fleet_env
    servers = [c.server for c in fleet.cells.values()][:2]
    bulk = ServingFleet({f"q{i}": s for i, s in enumerate(servers)},
                        max_queue_rows=64)
    shed = 0
    for i in range(20):
        try:
            bulk.submit(xt[:60], key=f"jam-{i}")
        except FleetOverloadError as err:
            assert err.reason == "queue_depth" and err.cell in bulk.cells
            shed += 1
    assert shed > 0 and bulk.shed_counts["queue_depth"] == shed
    assert bulk.metrics().shed_total == shed
    bulk.drain()


# ------------------------------------------------ poison + dead letters
def test_poison_request_dead_letters_others_survive(fleet_env):
    _, _, _, fleet, single, xt = fleet_env
    good = {}
    for i in range(6):
        chunk = xt[i * 8:(i + 1) * 8]
        good[fleet.submit(chunk, key=f"good-{i}")] = chunk
    bad_rows = np.zeros((5, xt.shape[1] + 3))
    bad = fleet.submit(bad_rows, key="poison-1")
    out = fleet.drain()
    assert set(out) == set(good)
    for rid, chunk in good.items():
        np.testing.assert_array_equal(out[rid], single.serve(chunk))
    letters = [d for d in fleet.dead_letters if d.rid == bad]
    assert len(letters) == 1
    d = letters[0]
    assert d.key == "poison-1" and d.x.shape == bad_rows.shape
    assert isinstance(d.error, PoisonedWaveError)
    assert d.poisons == fleet.max_poison_retries + 1
    assert fleet.metrics().dead_letters >= 1


# ------------------------------------- RequestQueue multi-producer safety
def test_request_queue_concurrent_submit_is_atomic(fleet_env):
    _, _, _, _, single, xt = fleet_env
    queue = RequestQueue(single)
    n_threads, per_thread = 8, 25
    rid_lists = [[] for _ in range(n_threads)]
    chunks: dict = {}
    barrier = threading.Barrier(n_threads)

    def producer(t):
        barrier.wait()
        for j in range(per_thread):
            chunk = xt[(t * per_thread + j) % 100:][:3 + (j % 5)]
            rid = queue.submit(chunk)
            rid_lists[t].append(rid)
            chunks[rid] = chunk

    threads = [threading.Thread(target=producer, args=(t,))
               for t in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    rids = [r for lst in rid_lists for r in lst]
    assert len(rids) == len(set(rids)) == n_threads * per_thread
    assert queue.pending_requests() == len(rids)
    assert queue.pending_rows() == sum(len(c) for c in chunks.values())
    out = queue.drain()
    assert set(out) == set(rids)
    for rid in rids:
        np.testing.assert_array_equal(out[rid], single.serve(chunks[rid]))


# ------------------------------------------- per-cell bucket autotune
def test_fleet_autotune_per_cell_no_recompile_of_survivors(fleet_env):
    fed, model, _, _, single, xt = fleet_env
    cfg = ServeConfig(buckets=(32, 128), autotune_buckets=True)
    fleet = fed.serve_fleet(model, cfg, n_cells=2).warmup()
    names = fleet.cells_up()
    small_cell, big_cell = names[0], names[1]
    seen = {small_cell: 0, big_cell: 0}
    for i in range(200):
        key = f"t-{i}"
        target = fleet.ring.route(key)
        fleet.submit(xt[:4 if target == small_cell else 120], key=key)
        fleet.drain()
        seen[target] += 1
        if min(seen.values()) >= 12:
            break
    pre = {n: (tuple(c.server.buckets), c.server.compile_count)
           for n, c in fleet.cells.items()}
    assert fed.serve_fleet(model, cfg, n_cells=2) is fleet
    for n, cell in fleet.cells.items():
        warm_buckets, warm_compiles = pre[n]
        cell.server.warmup()
        new = set(cell.server.buckets) - set(warm_buckets)
        assert cell.server.compile_count == warm_compiles + len(new)
    tuned = {n: tuple(c.server.buckets) for n, c in fleet.cells.items()}
    assert tuned[small_cell] != tuned[big_cell]
    rid = fleet.submit(xt[:50], key="after-tune")
    np.testing.assert_array_equal(fleet.drain()[rid], single.serve(xt[:50]))


def test_fleet_refreshes_cells_when_trees_change(fleet_env):
    """A refit under a cached fleet refreshes every cell in place."""
    fed, _, _, _, _, xt = fleet_env
    p = ForestParams(**{**KW, "n_estimators": 2})
    model = fed.fit(p)
    cfg = ServeConfig(buckets=(64,))
    fleet = fed.serve_fleet(model, cfg, n_cells=2)
    model.params = dataclasses.replace(p, n_estimators=3)
    model.fit(fed._partition, fed.labels_)
    assert fed.serve_fleet(model, cfg, n_cells=2) is fleet
    for cell in fleet.cells.values():
        assert int(cell.server.trees.is_leaf.shape[1]) == 3
    rid = fleet.submit(xt[:40], key="refit")
    np.testing.assert_array_equal(fleet.drain()[rid], model.predict(xt[:40]))


# ------------------------------------------------- zero stats record
def test_fresh_server_stats_zero_record(fleet_env):
    fed, model, cfg, _, _, _ = fleet_env
    fleet = fed.serve_fleet(model, cfg, n_cells=2, max_queue_rows=1024)
    for cell in fleet.cells.values():
        s = cell.server.stats()
        assert s["waves"] == s["rows"] == 0
        assert s["p50_ms"] == s["p95_ms"] == s["p99_ms"] == 0.0
        assert s["rows_per_s"] == 0.0 and s["comm_bytes_total"] == 0
    m = fleet.metrics()
    assert m.rows == 0 and m.rows_per_s == 0.0 and m.p99_ms == 0.0
    assert m.cells_up == 2 and not alerts(m, AlertThresholds(cells_down=1))


def test_busy_seconds_unions_overlaps():
    assert busy_seconds([(0.0, 1.0), (0.5, 2.0), (3.0, 4.0)]) == 3.0
    assert busy_seconds([]) == 0.0


# ------------------------------------------- "auto" build-knob resolution
def test_auto_build_params_bit_identical():
    x, y = make_classification(300, 12, 2, seed=0)
    base = dict(n_estimators=4, max_depth=6, n_bins=16, seed=1)
    p_auto = ForestParams(frontier_cap="auto", trees_per_batch="auto",
                          **base)
    assert p_auto.needs_resolution
    ff_auto = fit_federated_forest(x, y, 3, p_auto, device="cpu")
    assert not ff_auto.params.needs_resolution
    assert isinstance(ff_auto.params.frontier_cap, int)
    ff_dense = fit_federated_forest(x, y, 3, ForestParams(
        frontier_cap=0, trees_per_batch=1, **base), device="cpu")
    for a, b in zip(ff_auto.trees_, ff_dense.trees_):
        assert np.array_equal(a.numpy(), b.numpy())
    p_expl = ForestParams(frontier_cap=96, trees_per_batch=2, **base)
    assert p_expl.resolved(300) is p_expl
    with pytest.raises(ValueError, match="auto"):
        ForestParams(frontier_cap="adaptive", **base)
    with pytest.raises(ValueError, match="auto"):
        ForestParams(trees_per_batch="max", **base)


def test_auto_params_rejected_by_fit_program():
    from repro_torch.federation import programs
    from repro_torch.federation.substrate import default_substrate
    p = ForestParams(frontier_cap="auto", n_bins=16)
    with pytest.raises(ValueError, match="resolved"):
        programs.forest_fit_program(default_substrate(None), p)
