"""The port's serving engine on the CPU: twins of tests/test_serving.py's
server, queue, async-ring and autotune tests and of tests/test_federation.py's
session serve tests, plus served predictions held against the JAX
package's ``predict`` on the same data and seed.

Across packages: forest classification and boosting labels are equal bit
for bit (integer-exact sums, single-nonzero votes); forest regression, on
the JAX forest's own trees carried into a port server, within
tests/test_torch_prediction.py's rtol 1e-6 / atol 1e-6; regression
boosting within the JAX test's rtol 1e-4 / atol 1e-4 of the per-round
float64 predict (one fused float32 program sums in another order); F-LR
labels equal on the JAX model's own weights.  JAX runs through
``predict``, not its AOT servers.  Inside the port the engine's contracts
hold bit for bit: compile-once per bucket and per autotune epoch, bucket
routing, sync == async, queue scatter, zero-row dtypes and roll-back.

On the CPU a bucket's compiled program is the eager one
(``SimulatedSubstrate.aot_compile``); the card's CUDA graphs are held in
tests/test_torch_cuda.py.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.boosting import BoostParams as JBoostParams
from repro.core.boosting import FederatedBoosting as JBoosting
from repro.core.fedlinear import FederatedLinear as JLinear
from repro.core.forest import FederatedForest as JForest
from repro.core.party import make_vertical_partition as j_make_partition
from repro.core.types import ForestParams as JParams
from repro_torch import ckpt, convert
from repro_torch.core import (BoostParams, FederatedForest, ForestParams,
                              LinearParams, fit_federated_forest,
                              make_vertical_partition)
from repro_torch.core.fedlinear import FederatedLinear, split_columns
from repro_torch.core.tree import PartyTree
from repro_torch.data import make_classification, make_regression
from repro_torch.federation import Federation
from repro_torch.federation.substrate import SimulatedSubstrate
from repro_torch.serving import (BoostingServer, ForestServer, LinearServer,
                                 RequestQueue, ServeConfig, autotune_buckets,
                                 load_forest_trees, observed_row_counts)

CLS_KW = dict(n_classes=3, n_estimators=5, max_depth=6, n_bins=16, seed=1)
REG_KW = dict(task="regression", n_estimators=4, max_depth=6, n_bins=16,
              seed=3)


@pytest.fixture(scope="module")
def cls_forest():
    x, y = make_classification(900, 24, 3, seed=0)
    ff = fit_federated_forest(x[:700], y[:700], 3, ForestParams(**CLS_KW),
                              device="cpu")
    return ff, x[700:]


@pytest.fixture(scope="module")
def reg_forest():
    x, y = make_regression(600, 18, seed=2)
    ff = fit_federated_forest(x[:450], y[:450], 2, ForestParams(**REG_KW),
                              device="cpu")
    return ff, x[450:]


def _cpu_fed(parties, **kw):
    return Federation(parties=parties, device="cpu", **kw)


# ----------------------------------------------------- against the JAX package
def test_served_classification_equals_jax_predict(cls_forest):
    """The port's served labels == the JAX forest's predict, bit for bit
    (same data, seed and params: the forests themselves are equal)."""
    ff, xte = cls_forest
    x, y = make_classification(900, 24, 3, seed=0)
    jff = JForest(JParams(**CLS_KW)).fit(j_make_partition(x[:700], 3, 16),
                                         y[:700])
    want = np.asarray(jff.predict(xte))
    for compact in (True, False):
        server = ForestServer.from_forest(ff, buckets=(32, 128),
                                          compact=compact, max_inflight=3)
        np.testing.assert_array_equal(server.serve(xte), want)


def test_served_regression_equals_jax_predict_on_its_trees():
    """The JAX forest's own trees served by the port, within
    test_torch_prediction.py's rtol 1e-6 / atol 1e-6 of JAX's predict."""
    x, y = make_regression(600, 18, seed=2)
    jpart = j_make_partition(x[:450], 2, 16)
    jff = JForest(JParams(**REG_KW)).fit(jpart, y[:450])
    part = convert.partition_from_numpy(jpart.xb, jpart.feat_gid,
                                        jpart.n_features, jpart.boundaries)
    server = ForestServer(convert.party_trees_from_numpy(jff.trees_, "cpu"),
                          ForestParams(**REG_KW), buckets=(16, 64),
                          partition=part)
    np.testing.assert_allclose(server.serve(x[450:]),
                               np.asarray(jff.predict(x[450:])),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("task", ["binary", "regression"])
def test_boosting_served_equals_jax_predict(task):
    """The JAX boosting model's rounds and base served by the port: binary
    labels equal bit for bit; regression within the JAX test's 1e-4."""
    if task == "binary":
        x, y = make_classification(600, 12, 2, seed=1)
    else:
        x, y = make_regression(600, 12, seed=0)
    kw = dict(task=task, n_rounds=4, max_depth=4, n_bins=16)
    jpart = j_make_partition(x[:450], 2, 16)
    jb = JBoosting(JBoostParams(**kw)).fit(jpart, y[:450])
    part = convert.partition_from_numpy(jpart.xb, jpart.feat_gid,
                                        jpart.n_features, jpart.boundaries)
    rounds = [convert.party_trees_from_numpy(t, "cpu") for t in jb.trees_]
    server = BoostingServer(rounds, jb.base_, BoostParams(**kw),
                            buckets=(32, 128), partition=part)
    got, want = server.serve(x[450:]), np.asarray(jb.predict(x[450:]))
    if task == "binary":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_linear_served_labels_equal_jax_predict():
    """F-LR on the JAX model's weights and moments: the port's served
    labels == JAX's predict, and == the port's own predict."""
    x, y = make_classification(600, 20, 2, seed=4)
    blocks = split_columns(x[:500], 3)
    jm = JLinear().fit(blocks, y[:500])
    part = make_vertical_partition(x[:500], 3, 16)
    model = FederatedLinear(device="cpu")
    model._blocks(part)                         # binds the column split
    model._mu, model._sd = jm._mu, jm._sd
    model._w = torch.as_tensor(np.array(jm._w))
    model._b = torch.as_tensor(np.array(jm._b))
    server = LinearServer(model, buckets=(32, 64))
    got = server.serve(x[500:])
    np.testing.assert_array_equal(got, np.asarray(jm.predict(
        split_columns(x[500:], 3))))
    np.testing.assert_array_equal(got, model.predict(split_columns(x[500:],
                                                                   3)))


def test_cpu_compile_is_the_eager_program():
    """On CPU tensors the substrate compiles nothing: the runner is the
    program itself (the CPU has no CUDA graphs)."""
    sub = SimulatedSubstrate()
    prog = sub.program(lambda a, b: a + b, 1, 1)
    assert sub.aot_compile(prog, torch.ones(2, 3), torch.ones(3)) is prog


# ------------------------------------------------------ checkpoint round-trip
def test_forest_checkpoint_roundtrip(cls_forest, tmp_path):
    """save/restore of the fitted PartyTree stack, and
    ForestServer.from_checkpoint serving it."""
    ff, xte = cls_forest
    ckpt.save_checkpoint(tmp_path, 5, ff.trees_)
    restored = load_forest_trees(str(tmp_path), device="cpu")
    for a, b in zip(ff.trees_, restored):
        assert torch.equal(a, b)
    server = ForestServer.from_checkpoint(
        str(tmp_path), ff.params, buckets=(64, 256), device="cpu",
        partition=ff.partition_, decode=ff._decode)
    np.testing.assert_array_equal(server.serve(xte), ff.predict(xte))


# ------------------------------------------------------------- the server
def test_server_compile_once_across_buckets(cls_forest):
    ff, xte = cls_forest
    server = ForestServer.from_forest(ff, buckets=(8, 32, 128))
    server.warmup()
    assert server.compile_count == 3
    want = ff.predict(xte)
    for n in (3, 8, 20, 32, 97, 128, 60, 5):                 # hits all buckets
        np.testing.assert_array_equal(server.serve(xte[:n]), want[:n])
    assert server.compile_count == 3                         # no recompiles
    assert {w["bucket"] for w in server.wave_stats} == {8, 32, 128}
    stats = server.stats_summary()
    assert stats["waves"] == 8 and stats["rows_per_s"] > 0


def test_server_micro_batches_oversized_requests(cls_forest):
    """200 rows -> three 64-row waves + one 8-row tail (16-bucket)."""
    ff, xte = cls_forest
    server = ForestServer.from_forest(ff, buckets=(16, 64))
    np.testing.assert_array_equal(server.serve(xte), ff.predict(xte))
    assert server.compile_count == 2
    assert sum(w["n_rows"] for w in server.wave_stats) == len(xte)
    assert [w["bucket"] for w in server.wave_stats] == [64, 64, 64, 16]


def test_server_dense_equals_compact(cls_forest):
    ff, xte = cls_forest
    dense = ForestServer.from_forest(ff, compact=False, buckets=(64,))
    compact = ForestServer.from_forest(ff, compact=True, buckets=(64,))
    np.testing.assert_array_equal(dense.serve(xte), compact.serve(xte))
    assert (compact.wave_stats[-1]["comm_bytes"]
            < dense.wave_stats[-1]["comm_bytes"])


def test_server_regression_task(reg_forest):
    ff, xte = reg_forest
    server = ForestServer.from_forest(ff, buckets=(32, 128))
    np.testing.assert_array_equal(server.serve(xte), ff.predict(xte))


def test_server_empty_batch(cls_forest):
    ff, xte = cls_forest
    server = ForestServer.from_forest(ff, buckets=(32,))
    assert server.serve(xte[:0]).shape == (0,)
    assert len(server.wave_stats) == 0


# -------------------------------------------------------------- the queue
def test_queue_coalesces_and_scatters(cls_forest):
    ff, xte = cls_forest
    server = ForestServer.from_forest(ff, buckets=(64,))
    queue = RequestQueue(server, max_wave_rows=64)
    want = ff.predict(xte)
    sizes, rids, spans, lo = [5, 50, 90, 1, 17], [], [], 0
    for s in sizes:
        rids.append(queue.submit(xte[lo:lo + s]))
        spans.append((lo, s))
        lo += s
    results = queue.drain()
    assert set(results) == set(rids)
    for rid, (start, s) in zip(rids, spans):
        np.testing.assert_array_equal(results[rid], want[start:start + s])
    assert len(queue.request_stats) == len(sizes)
    assert len(server.wave_stats) <= 5


def test_queue_zero_row_request_does_not_wedge(cls_forest):
    ff, xte = cls_forest
    queue = RequestQueue(ForestServer.from_forest(ff, buckets=(32,)))
    r0, r1 = queue.submit(xte[:0]), queue.submit(xte[:7])
    results = queue.drain()
    assert results[r0].shape == (0,)
    np.testing.assert_array_equal(results[r1], ff.predict(xte[:7]))
    r2 = queue.submit(xte[7:12])
    np.testing.assert_array_equal(queue.drain()[r2], ff.predict(xte[7:12]))


def test_queue_cross_wave_request_spanning(cls_forest):
    ff, xte = cls_forest
    want = ff.predict(xte)
    for inflight in (1, 3):
        server = ForestServer.from_forest(ff, buckets=(16, 64),
                                          max_inflight=inflight)
        queue = RequestQueue(server, max_wave_rows=64)
        big, small = queue.submit(xte), queue.submit(xte[:5])
        results = queue.drain()
        np.testing.assert_array_equal(results[big], want)
        np.testing.assert_array_equal(results[small], want[:5])
        assert len(server.wave_stats) >= 4


@pytest.mark.parametrize("mask_regression", [False, True])
def test_queue_zero_row_dtype_matches_decoded(mask_regression):
    x, y = make_regression(400, 10, seed=4)
    p = ForestParams(task="regression", n_estimators=2, max_depth=4,
                     n_bins=16, seed=5)
    ff = fit_federated_forest(x[:300], y[:300], 2, p, device="cpu",
                              mask_regression=mask_regression)
    server = ForestServer.from_forest(ff, buckets=(32,))
    queue = RequestQueue(server)
    rz, rn = queue.submit(x[:0]), queue.submit(x[300:340])
    results = queue.drain()
    assert results[rz].dtype == results[rn].dtype
    assert results[rz].shape == (0,)
    assert server.serve(x[:0]).dtype == results[rn].dtype
    np.testing.assert_array_equal(results[rn], ff.predict(x[300:340]))


@pytest.mark.parametrize("task", ["classification", "regression"])
def test_queue_drain_parity_with_serve(cls_forest, reg_forest, task):
    ff, xte = cls_forest if task == "classification" else reg_forest
    server = ForestServer.from_forest(ff, buckets=(32, 64))
    queue = RequestQueue(server)
    rids = [queue.submit(xte[:50]), queue.submit(xte[50:83])]
    results = queue.drain()
    direct = server.serve(xte[:83])
    got = np.concatenate([results[rids[0]], results[rids[1]]])
    assert got.dtype == direct.dtype
    np.testing.assert_array_equal(got, direct)
    np.testing.assert_array_equal(direct, ff.predict(xte[:83]))


# -------------------------------------------------------- async wave ring
@pytest.mark.parametrize("fixture", ["cls", "reg"])
def test_async_bit_identical_to_sync(cls_forest, reg_forest, fixture):
    ff, xte = cls_forest if fixture == "cls" else reg_forest
    sync = ForestServer.from_forest(ff, buckets=(16, 64), max_inflight=1)
    asyn = ForestServer.from_forest(ff, buckets=(16, 64), max_inflight=4)
    got_s, got_a = sync.serve(xte), asyn.serve(xte)
    assert got_s.dtype == got_a.dtype
    np.testing.assert_array_equal(got_s, got_a)
    assert max(w["inflight"] for w in asyn.wave_stats) > 1
    assert max(w["inflight"] for w in sync.wave_stats) == 1
    want = ff.predict(xte)
    spans = ((0, 5), (5, 90), (95, 33), (128, 1))
    for server in (sync, asyn):
        q = RequestQueue(server, max_wave_rows=64)
        rids = [q.submit(xte[lo:lo + s]) for lo, s in spans]
        res = q.drain()
        for rid, (lo, s) in zip(rids, spans):
            np.testing.assert_array_equal(res[rid], want[lo:lo + s])


def test_dispatch_wave_rejects_oversized_and_empty(cls_forest):
    ff, xte = cls_forest
    server = ForestServer.from_forest(ff, buckets=(16,))
    xb = ff.partition_.bin_test(np.asarray(xte))
    with pytest.raises(ValueError, match="wave of"):
        server.dispatch_wave(xb[:, :17])
    with pytest.raises(ValueError, match="wave of"):
        server.dispatch_wave(xb[:, :0])


def test_queue_drain_failure_leaves_rows_redispatchable(cls_forest):
    ff, xte = cls_forest
    server = ForestServer.from_forest(ff, buckets=(16, 64), max_inflight=2)
    queue = RequestQueue(server, max_wave_rows=64)
    rids = [queue.submit(xte[:90]), queue.submit(xte[90:120])]
    real_dispatch, boom = server.dispatch_wave, [True]

    def failing(xb):
        if boom[0]:
            boom[0] = False
            raise RuntimeError("transient dispatch failure")
        return real_dispatch(xb)

    server.dispatch_wave = failing
    with pytest.raises(RuntimeError):
        queue.drain()
    assert server._n_inflight == 0
    server.dispatch_wave = real_dispatch
    results = queue.drain()
    want = ff.predict(xte[:120])
    np.testing.assert_array_equal(results[rids[0]], want[:90])
    np.testing.assert_array_equal(results[rids[1]], want[90:120])
    with pytest.raises(ValueError, match="width"):
        queue.submit(np.zeros((server.n_parties, 4, server._fp() + 1),
                              np.uint8), binned=True)
    with pytest.raises(ValueError, match="binned request"):
        queue.submit(np.zeros((server.n_parties + 2, 4, server._fp()),
                              np.uint8), binned=True)


# ----------------------------------------------- serving-path guard rails
def test_serve_binned_rejects_width_mismatch(cls_forest):
    ff, _ = cls_forest
    server = ForestServer.from_forest(ff, buckets=(32,))
    fp = server._fp()
    bad = np.zeros((server.n_parties, 10, fp + 3), np.uint8)
    with pytest.raises(ValueError, match=rf"width {fp + 3}.*width {fp}"):
        server.serve_binned(bad)
    free = ForestServer(ff.trees_, ff.params, buckets=(32,),
                        n_features_per_party=fp)
    with pytest.raises(ValueError, match="width"):
        free.serve_binned(bad)


def test_strip_raises_on_unexpected_rank(cls_forest):
    ff, _ = cls_forest
    server = ForestServer.from_forest(ff, buckets=(32,))
    with pytest.raises(ValueError, match="unexpected shape"):
        server._strip(np.zeros((4, 5, 6)), 5)
    with pytest.raises(ValueError, match="unexpected shape"):
        server._strip(np.zeros((server.n_parties + 1, 5)), 5)
    assert server._strip(np.arange(8), 5).shape == (5,)
    assert server._strip(np.zeros((server.n_parties, 8)), 5).shape == (5,)


# ------------------------------------------------------- bucket autotuning
def test_autotune_buckets_from_traffic():
    from repro.serving import autotune_buckets as j_autotune
    rng = np.random.default_rng(0)
    counts = rng.integers(1, 300, size=100)
    buckets = autotune_buckets(counts, warm=(32, 256, 2048))
    assert buckets == j_autotune(counts, warm=(32, 256, 2048))
    assert list(buckets) == sorted(set(buckets)) and len(buckets) <= 4
    assert buckets[-1] >= counts.max()
    assert autotune_buckets([5, 7], warm=(32, 256)) == (32, 256)
    rows = observed_row_counts([{"n_rows": 3}, {"rows": 9}, {"n_rows": 0}],
                               [4, 0])
    assert rows.tolist() == [3, 9, 4]


def test_autotuned_buckets_compile_once(cls_forest):
    ff, xte = cls_forest
    server = ForestServer.from_forest(ff, buckets=(32, 128))
    server.warmup()
    assert server.compile_count == 2
    for n in (3, 30, 100, 128):
        server.serve(xte[:n])
    assert server.compile_count == 2
    tuned = autotune_buckets(server.wave_stats, warm=server.buckets,
                             min_observations=4)
    server.set_buckets(tuned)
    server.warmup()
    epoch_compiles = server.compile_count
    assert epoch_compiles <= 2 + len(tuned)
    for n in (3, 30, 100, int(tuned[-1])):
        np.testing.assert_array_equal(server.serve(xte[:n]),
                                      ff.predict(xte[:n]))
    assert server.compile_count == epoch_compiles
    if 128 in tuned:
        assert epoch_compiles < 2 + len(tuned)


# ------------------------------------------------- the session's serve
@pytest.fixture(scope="module")
def cls_data():
    x, y = make_classification(700, 18, 3, seed=0)
    return x[:500], y[:500], x[500:], y[500:]


@pytest.fixture(scope="module")
def reg_data():
    x, y = make_regression(500, 12, seed=1)
    return x[:400], y[:400], x[400:], y[400:]


def test_serve_with_knobs_is_not_cached(cls_data):
    xtr, ytr = cls_data[0], cls_data[1]
    fed = _cpu_fed(2, n_bins=8)
    fed.ingest(xtr, ytr)
    model = fed.fit(ForestParams(n_estimators=2, max_depth=4, n_bins=8,
                                 n_classes=3))
    with pytest.warns(DeprecationWarning):
        s1 = fed.serve(model, buckets=(32,))
    s2 = fed.serve(model, ServeConfig(buckets=(32,)), vote_impl="argmax")
    assert s2 is not s1 and s2.vote_impl == "argmax"
    assert fed.serve(model, ServeConfig(buckets=(32,))) is s1


def test_serve_refreshes_server_when_trees_change(cls_data):
    xtr, ytr, xte, _ = cls_data
    p = ForestParams(n_estimators=3, max_depth=6, n_bins=16, n_classes=3,
                     seed=5)
    fed = _cpu_fed(2, n_bins=16)
    fed.ingest(xtr, ytr)
    model = fed.fit(p)
    cfg = ServeConfig(buckets=(32, 64))
    server = fed.serve(model, cfg)
    server.warmup()
    assert server.compile_count == 2
    assert fed.serve(model, cfg) is server
    assert server.compile_count == 2
    np.testing.assert_array_equal(server.serve(xte), model.predict(xte))
    model.params = dataclasses.replace(p, n_estimators=5)
    model.fit(fed._partition, ytr)
    assert fed.serve(model, cfg) is server                # refreshed in place
    assert int(server.trees.is_leaf.shape[1]) == 5
    np.testing.assert_array_equal(server.serve(xte), model.predict(xte))
    assert server.compile_count > 2


def test_serve_boosting_model(reg_data):
    rxtr, rytr, rxte, _ = reg_data
    fed = _cpu_fed(2, n_bins=16)
    fed.ingest(rxtr, rytr)
    model = fed.fit(BoostParams(n_rounds=4, max_depth=3, n_bins=16))
    cfg = ServeConfig(buckets=(32, 64), max_inflight=3)
    server = fed.serve(model, cfg)
    assert fed.serve(model, cfg) is server
    server.warmup()
    assert server.compile_count == 2
    out = server.serve(rxte)
    # one fused float32 program vs the per-round float64 host accumulation
    np.testing.assert_allclose(out, model.predict(rxte), rtol=1e-4,
                               atol=1e-4)
    assert server.compile_count == 2
    assert server.serve(rxte[:0]).dtype == out.dtype


def test_serve_boosting_binary(cls_data):
    xtr, ytr, xte, _ = cls_data
    fed = _cpu_fed(2, n_bins=16)
    fed.ingest(xtr, (ytr == 1).astype(np.float64))
    model = fed.fit(BoostParams(task="binary", n_rounds=3, max_depth=3,
                                n_bins=16))
    server = fed.serve(model, ServeConfig(buckets=(64,)))
    np.testing.assert_array_equal(server.serve(xte),
                                  model.predict(xte).astype(np.int32))


def test_serve_linear_model(cls_data):
    xtr, ytr, xte, _ = cls_data
    fed = _cpu_fed(3)
    part = fed.ingest(xtr, ytr)
    model = fed.fit(LinearParams(steps=150))
    server = fed.serve(model, ServeConfig(buckets=(32, 128)))
    assert isinstance(server, LinearServer)
    server.warmup()
    assert server.compile_count == 2
    want = model.predict(part.split_raw(xte))
    np.testing.assert_array_equal(server.serve(xte), want)
    assert server.compile_count == 2
    q = RequestQueue(server)
    rid = q.submit(xte[:40])
    np.testing.assert_array_equal(q.drain()[rid], want[:40])


def test_serve_autotune_refreshes_buckets(cls_data):
    xtr, ytr, xte, _ = cls_data
    fed = _cpu_fed(2, n_bins=8)
    fed.ingest(xtr, ytr)
    model = fed.fit(ForestParams(n_estimators=2, max_depth=4, n_bins=8,
                                 n_classes=3, seed=9))
    counts = list(np.random.default_rng(0).integers(1, 120, size=50))
    cfg = ServeConfig(autotune_buckets=True)
    server = fed.serve(model, cfg, traffic=counts)
    server.warmup()
    assert server.buckets[-1] >= max(counts)
    assert server.compile_count == len(server.buckets)
    for n in (3, 40, 100):
        np.testing.assert_array_equal(server.serve(xte[:n]),
                                      model.predict(xte[:n]))
    assert server.compile_count == len(server.buckets)
    assert fed.serve(model, cfg) is server


def test_loaded_boosting_model_serves(reg_data, tmp_path):
    rxtr, rytr, rxte, _ = reg_data
    fed = _cpu_fed(2, n_bins=16)
    fed.ingest(rxtr, rytr)
    spec = BoostParams(n_rounds=3, max_depth=3, n_bins=16)
    model = fed.fit(spec)
    fed.save(model, str(tmp_path / "boost"))
    restored = fed.load(str(tmp_path / "boost"), spec)
    server = fed.serve(restored, ServeConfig(buckets=(64,)))
    np.testing.assert_allclose(server.serve(rxte), model.predict(rxte),
                               rtol=1e-4, atol=1e-4)


def test_load_takes_trees_and_decode(cls_data, tmp_path):
    """load(trees=, decode=): a stack already in memory is used as it is,
    and an explicit decode wins over the reconstructed one."""
    xtr, ytr, xte, _ = cls_data
    fed = _cpu_fed(2, n_bins=16)
    fed.ingest(xtr, ytr)
    p = ForestParams(n_estimators=2, max_depth=4, n_bins=16, n_classes=3)
    model = fed.fit(p)
    fed.save(model, str(tmp_path))
    trees = load_forest_trees(str(tmp_path), device="cpu")
    loaded = fed.load(str(tmp_path), p, trees=trees, decode=model._decode)
    assert loaded.trees_ is trees and loaded._decode is model._decode
    np.testing.assert_array_equal(loaded.predict(xte), model.predict(xte))
    assert isinstance(loaded, FederatedForest)
    assert isinstance(loaded.trees_, PartyTree)
