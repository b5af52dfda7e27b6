"""The port's party-per-process substrate: the correctness oracle.

A real 3-party localhost deployment on the CPU (one OS process per party,
message-passing collectives over sockets, ``device="cpu"``) gives the port's
simulated substrate's results bit for bit: forests on both tasks in all
seven PartyTree fields, predictions, answers served through
``fed.serve``, and partitions ingested from blocks, CSVs and streams (with
``ingest_append``); the classification forest also equals the JAX
package's simulated one.  ``validate=True``, the F-LR fit and boosting
serving are refused there, and with no card the substrate raises before it
spawns anything.  The egress guard is armed for the whole suite
(tests/conftest.py; the workers inherit it): guarded traffic is
bit-identical to the JAX package's simulated session, and a raw block sent
through the coordinator is refused before it is framed.  The fault cases are tests/test_torch_distributed_faults.py.
"""
import multiprocessing

import numpy as np
import pytest
import torch

from repro.core import ForestParams as JParams
from repro.core.partyblock import PartyBlock as JBlock
from repro.federation import Federation as JFederation
from repro_torch import convert
from repro_torch.analysis import runtime as egress_rt
from repro_torch.core import ForestParams
from repro_torch.core import crypto
from repro_torch.core.boosting import BoostParams
from repro_torch.core.fedlinear import LinearParams
from repro_torch.core.partyblock import CSVSource, PartyBlock
from repro_torch.data import (make_classification, make_party_views,
                              make_regression)
from repro_torch.federation import DistributedSubstrate, Federation
from repro_torch.federation.transport import RetryPolicy
from repro_torch.observability import registry as telemetry
from repro_torch.serving import ForestServer, ServeConfig
from repro_torch.streaming import ArraySource

M = 3


def _trees_equal(a, b):
    ta, tb = (convert.party_trees_to_numpy(t) for t in (a, b))
    for f in ta:
        np.testing.assert_array_equal(ta[f], tb[f], err_msg=f)


def _parts_equal(a, b):
    np.testing.assert_array_equal(a.xb, b.xb)
    np.testing.assert_array_equal(a.feat_gid, b.feat_gid)
    np.testing.assert_array_equal(a.boundaries, b.boundaries)
    assert a.n_features == b.n_features
    assert a.party_names == b.party_names


def _sim(n_bins=8):
    return Federation(parties=M, n_bins=n_bins, device="cpu")


@pytest.fixture(scope="module")
def dist_fed():
    """One 3-party deployment shared by this module's tests (the fault
    tests build their own — they kill workers)."""
    fed = Federation(parties=M, substrate="distributed", n_bins=8,
                     device="cpu", round_timeout=60.0,
                     retry=RetryPolicy(attempts=2, base=0.05, seed=0))
    yield fed
    fed.close()


def _data(task):
    if task == "classification":
        return make_classification(120, 6, 2, seed=0)
    return make_regression(120, 6, seed=1)


# ------------------------------------------------------------------- oracle
@pytest.mark.parametrize("task", ["classification", "regression"])
def test_fit_predict_bit_identity(dist_fed, task):
    x, y = _data(task)
    p = ForestParams(task=task, n_estimators=3, max_depth=3, n_bins=8,
                     seed=0)
    sim = _sim()
    sim.ingest(x, y)
    ref = sim.fit(p)
    dist_fed.ingest(x, y)
    model = dist_fed.fit(p)
    assert model.trees_.is_leaf.device == torch.device("cpu")
    _trees_equal(ref.trees_, model.trees_)
    xt = x[:40]
    np.testing.assert_array_equal(dist_fed.predict(model, xt),
                                  sim.predict(ref, xt))
    np.testing.assert_array_equal(model.predict(xt), ref.predict(xt))
    if task == "classification":        # also the JAX package's forest
        jfed = JFederation(parties=M, n_bins=8)
        jfed.ingest(x, y)
        jref = jfed.fit(JParams(task=task, n_estimators=3, max_depth=3,
                                n_bins=8, seed=0))
        got = convert.party_trees_to_numpy(model.trees_)
        for f in got:
            np.testing.assert_array_equal(got[f],
                                          np.asarray(getattr(jref.trees_, f)),
                                          err_msg=f)
        np.testing.assert_array_equal(dist_fed.predict(model, xt),
                                      np.asarray(jfed.predict(jref, xt)))


def test_frontier_fit_and_histogram_launch_counter(dist_fed):
    """The frontier-compacted level search runs party-side too; the fit's
    histogram launches reach the session under ``party<i>.`` (on the CPU
    the plain version runs, so the CUDA kernel's counter stays 0)."""
    x, y = make_regression(300, 9, seed=2)
    p = ForestParams(task="regression", n_estimators=2, max_depth=5,
                     n_bins=8, seed=7, frontier_cap=3)
    sim = _sim()
    sim.ingest(x, y)
    dist_fed.ingest(x, y)
    _trees_equal(sim.fit(p).trees_, dist_fed.fit(p).trees_)
    got = dist_fed.collect_telemetry()
    assert sorted(got) == [0, 1, 2]
    assert telemetry.REGISTRY.get("party0.kernels.histogram.launches") is None
    with pytest.raises(RuntimeError, match="hist_subtraction"):
        dist_fed.fit(ForestParams(task="regression", n_estimators=1,
                                  max_depth=2, n_bins=8,
                                  hist_subtraction=True))


def test_served_answers_equal_simulated(dist_fed, tmp_path):
    """fed.serve on the distributed substrate: the trees ship once per
    bucket (a bind, no graph), waves take the host path and equal
    ``predict`` bit for bit, also from a checkpoint."""
    x, y = make_classification(150, 6, 2, seed=4)
    p = ForestParams(n_estimators=4, max_depth=3, n_bins=8, seed=1)
    sim = _sim()
    sim.ingest(x, y)
    ref = sim.fit(p)
    dist_fed.ingest(x, y)
    model = dist_fed.fit(p)
    server = dist_fed.serve(model, ServeConfig(buckets=(16, 64)))
    assert server.substrate is dist_fed.substrate
    want = sim.predict(ref, x)
    np.testing.assert_array_equal(server.serve(x), want)
    for n in (5, 16, 40):
        np.testing.assert_array_equal(server.serve(x[:n]), want[:n])
    assert server.compile_count == 2              # one bind per bucket
    assert not any(w.get("degraded") for w in server.wave_stats)
    dense = dist_fed.serve(model, ServeConfig(buckets=(64,), compact=False))
    np.testing.assert_array_equal(dense.serve(x[:64]), want[:64])
    # a checkpoint served through the same party processes
    dist_fed.save(model, str(tmp_path))
    restored = ForestServer.from_checkpoint(
        str(tmp_path), p, device="cpu", substrate=dist_fed.substrate,
        partition=model.partition_, buckets=(64,))
    assert restored.substrate is dist_fed.substrate
    np.testing.assert_array_equal(restored.serve(x), want)


def test_csv_ingest_matches_in_process(dist_fed, tmp_path):
    """Per-party CSV extracts ingested through the party processes (raw
    features and IDs never leave the worker) build the same partition — and
    the same forest — as the in-process path; validate=True is refused."""
    x, y = make_classification(90, 6, 2, seed=2)
    blocks, _, _ = make_party_views(x, y, M, overlap=0.8, seed=2)
    sources = [CSVSource(b.to_csv(str(tmp_path / f"{b.name}.csv")),
                         name=b.name) for b in blocks]
    sim = _sim()
    part_sim = sim.ingest(sources, validate=True)
    with pytest.raises(ValueError, match="validate"):
        dist_fed.ingest(sources, validate=True)
    part = dist_fed.ingest(sources)
    _parts_equal(part, part_sim)
    np.testing.assert_array_equal(dist_fed.labels_, sim.labels_)
    # the coordinator only ever sees hashed IDs
    np.testing.assert_array_equal(dist_fed.aligned_ids_,
                                  crypto.hash_ids(sim.aligned_ids_))
    p = ForestParams(n_estimators=2, max_depth=3, n_bins=8, seed=0)
    _trees_equal(sim.fit(p).trees_, dist_fed.fit(p).trees_)
    # in-memory blocks too (shipped to their own workers)
    _parts_equal(dist_fed.ingest(blocks), sim.ingest(blocks))


def _blocks_with_ids(x, y, prefix, seed):
    blocks, _, _ = make_party_views(x, y, M, overlap=1.0, seed=seed)
    return [PartyBlock(name=b.name, x=b.x,
                       ids=np.array([f"{prefix}{i}" for i in b.ids]),
                       y=b.y, feature_ids=b.feature_ids) for b in blocks]


def test_streamed_ingest_and_append_match_in_process(dist_fed):
    """Each worker streams and bins its own chunks; ``ingest_append`` ships
    one new source per party to the streams the workers hold.  Partition,
    labels, hashed IDs and the forest equal the in-process streamed
    ingest's, before and after the append."""
    x, y = make_classification(200, 6, 2, seed=21)
    x2, y2 = make_classification(80, 6, 2, seed=22)
    first = _blocks_with_ids(x, y, "a", 21)
    second = _blocks_with_ids(x2, y2, "b", 21)
    sim = _sim(16)
    part_sim = sim.ingest([ArraySource(b) for b in first], chunk_rows=33,
                          n_bins=16)
    part = dist_fed.ingest([ArraySource(b) for b in first], chunk_rows=33,
                           n_bins=16)
    assert dist_fed._stream["mode"] == "distributed"
    _parts_equal(part, part_sim)
    np.testing.assert_array_equal(dist_fed.aligned_ids_,
                                  crypto.hash_ids(sim.aligned_ids_))
    part_sim = sim.ingest_append([ArraySource(b) for b in second])
    part = dist_fed.ingest_append([ArraySource(b) for b in second])
    _parts_equal(part, part_sim)
    assert part.n_samples == 280
    np.testing.assert_array_equal(dist_fed.labels_, sim.labels_)
    np.testing.assert_array_equal(dist_fed.aligned_ids_,
                                  crypto.hash_ids(sim.aligned_ids_))
    p = ForestParams(n_estimators=2, max_depth=3, n_bins=16, seed=3)
    _trees_equal(sim.fit(p).trees_, dist_fed.fit(p).trees_)


def test_programs_and_other_families(dist_fed):
    """fit_program / predict_program carry the distributed protocol; a
    boosting fit runs through the forest fit protocol (as in the JAX
    package) and equals the simulated one, but boosting has no serving
    body there; the F-LR fit stays in process (no protocol body, as in
    the JAX package) while an F-LR model's predict runs over the wire."""
    x, y = make_classification(120, 6, 2, seed=5)
    sim = _sim()
    sim.ingest(x, y)
    dist_fed.ingest(x, y)
    p = ForestParams(n_estimators=2, max_depth=2, n_bins=8, seed=0)
    assert dist_fed.fit_program(p).spec["name"] == "forest_fit"
    assert dist_fed.predict_program(p, compact=True).spec["name"] \
        == "forest_predict"

    bp = BoostParams(task="binary", n_rounds=3, max_depth=2, n_bins=8)
    bref = sim.fit(bp)
    bmodel = dist_fed.fit(bp)
    for a, b in zip(bref.trees_, bmodel.trees_):
        _trees_equal(a, b)
    np.testing.assert_array_equal(bmodel.predict(x), bref.predict(x))
    with pytest.raises(NotImplementedError, match="boosting"):
        dist_fed.serve(bmodel)

    with pytest.raises(NotImplementedError, match="no distributed"):
        dist_fed.fit(LinearParams(steps=5))
    flr = sim.fit(LinearParams(steps=50))
    want = flr.predict(sim._partition)
    flr.substrate = dist_fed.substrate
    np.testing.assert_array_equal(flr.predict(sim._partition), want)


def test_no_card_raises_before_spawning():
    """Entry points default to the card: without one the substrate and the
    session raise at once, and no worker process is started."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    before = set(multiprocessing.active_children())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DistributedSubstrate(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Federation(parties=2, substrate="distributed")
    assert set(multiprocessing.active_children()) == before
    with pytest.raises(ValueError, match="runs on"):
        Federation(parties=2, device="cpu",
                   substrate=DistributedSubstrate(2, device="meta"))


def test_guarded_traffic_is_bit_identical(dist_fed):
    """tests/test_distributed.py's guarded-traffic test: with the guard
    armed, distributed ingest (a raw matrix and party blocks, provisioned
    under ``allow_egress``), fit and predict equal the JAX package's
    simulated session bit for bit — the guard only ever blocks, it never
    perturbs — and a raw send through the coordinator is refused."""
    assert egress_rt.enabled()
    x, y = make_classification(90, 6, 2, seed=7)
    p = ForestParams(n_estimators=2, max_depth=3, n_bins=8, seed=4)
    jfed = JFederation(parties=M, n_bins=8)
    jpart = jfed.ingest(x, y)
    jref = jfed.fit(JParams(n_estimators=2, max_depth=3, n_bins=8, seed=4))
    part = dist_fed.ingest(x, y)
    np.testing.assert_array_equal(part.xb, np.asarray(jpart.xb))
    model = dist_fed.fit(p)
    got = convert.party_trees_to_numpy(model.trees_)
    assert len(got) == 7
    for f in got:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(jref.trees_,
                                                                 f)),
                                      err_msg=f)
    np.testing.assert_array_equal(dist_fed.predict(model, x[:25]),
                                  np.asarray(jfed.predict(jref, x[:25])))

    blocks, _, _ = make_party_views(x, y, M, overlap=0.8, seed=7)
    part = dist_fed.ingest(blocks)
    jpart = jfed.ingest([JBlock(name=b.name, x=b.x, ids=b.ids, y=b.y,
                                feature_ids=b.feature_ids) for b in blocks])
    np.testing.assert_array_equal(part.xb, np.asarray(jpart.xb))
    np.testing.assert_array_equal(dist_fed.labels_, np.asarray(jfed.labels_))

    coord = dist_fed.substrate.coordinator
    for payload in (blocks[0].x, torch.from_numpy(blocks[0].x)[:5]):
        with pytest.raises(egress_rt.PrivacyViolationError) as ei:
            coord.request(0, {"op": "ping", "x": payload})
        assert ei.value.path == "msg['x']"
        assert "raw features" in ei.value.label
    assert coord.request(0, {"op": "ping"})["op"] == "pong"
