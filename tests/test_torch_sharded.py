"""The port's sharded substrate on the CPU: gloo ranks, one per mesh position.

A ``torch.distributed`` world of CPU processes (``launch/mesh.py``'s
``make_host_mesh`` / ``make_forest_mesh(devices="cpu")``) runs the protocol
rank to rank and gives the simulated substrate's results bit for bit:
``protocol.run_sharded == run_simulated`` on a toy psum; a classification
forest on a (1, 3) mesh equal to the JAX package's simulated substrate and
to the port's in all seven PartyTree fields, with its predictions and
served answers; regression's splits; a (2, 2) tree-parallel fit; boosting
on a (2, 1) mesh with ``tree_sharded=False``; ``hist_subtraction`` fits
and the classical predict on (1, 2) and (2, 2) meshes; F-LR; party-first
ingest and party-block serving; servers built on a mesh of their own; and the
refusals (no mesh, unknown substrate, party-count mismatch, NCCL with two
ranks on one device, a mesh on another kind of device than the session).
The rank pools are module-scoped: each world starts once.
"""
import numpy as np
import pytest
import torch

from repro.core import ForestParams as JParams
from repro.federation import Federation as JFederation
from repro_torch import convert
from repro_torch.core import ForestParams, crypto, protocol
from repro_torch.core.boosting import BoostParams
from repro_torch.core.fedlinear import LinearParams
from repro_torch.core.partyblock import PartyBlock
from repro_torch.core.types import PARTY_AXIS
from repro_torch.data import (make_classification, make_party_views,
                              make_regression)
from repro_torch.federation import Federation, resolve_substrate
from repro_torch.federation.substrate import ShardedSubstrate
from repro_torch.launch import mesh as mesh_mod
from repro_torch.observability import registry as telemetry
from repro_torch.serving import ForestServer, ServeConfig

GRIDS = {"1x3": (1, 3), "2x2": (2, 2), "2x1": (2, 1), "1x2": (1, 2)}
HIST_SUB = {"alone": {"hist_subtraction": True, "frontier_cap": 0},
            "frontier_cap": {"hist_subtraction": True, "frontier_cap": 3}}


@pytest.fixture(scope="module")
def pool():
    subs = {name: ShardedSubstrate(
        mesh_mod.make_forest_mesh(trees=t, parties=p, devices="cpu"),
        device="cpu") for name, (t, p) in GRIDS.items()}
    yield subs
    for sub in subs.values():
        sub.shutdown()


def _fed(pool, grid, **kw):
    t, p = GRIDS[grid]
    return Federation(parties=p, substrate=pool[grid], device="cpu", **kw)


def _sim(parties, **kw):
    return Federation(parties=parties, device="cpu", **kw)


def _rank_counts(fed, name: str) -> list[int]:
    """Each rank's own (cumulative) counter ``name``: every rollup adds a
    rank's whole count to the session's ``rank<r>.`` copy, so the count is
    the copy's growth over one rollup."""
    def merged(r):
        c = telemetry.REGISTRY.get(f"rank{r}.{name}")
        return 0 if c is None else c.value
    n = fed.substrate.mesh.size
    before = [merged(r) for r in range(n)]
    fed.collect_telemetry()
    return [merged(r) - b for r, b in enumerate(before)]


def _trees_equal(a, b, fields=None):
    ta, tb = (convert.party_trees_to_numpy(t) for t in (a, b))
    for f in fields or ta:
        np.testing.assert_array_equal(ta[f], tb[f], err_msg=f)


def toy_psum(x, scale, comm=None):
    """The JAX test's ``psum(x_i.sum()) * scale`` over the port's leading
    party dimension."""
    s = x.sum()
    if comm is not None:
        s = comm.psum(s)
    return s * scale


# ------------------------------------------------------------------ protocol
def test_run_sharded_matches_run_simulated_single_party():
    """protocol.run_sharded on a one-rank "parties" mesh == run_simulated
    (tests/test_federation.py's twin)."""
    x = np.arange(8.0, dtype=np.float32).reshape(1, 8)
    mesh = mesh_mod.make_host_mesh(1, axes=(PARTY_AXIS,), shape=(1,))
    sim = protocol.run_simulated(toy_psum, (torch.as_tensor(x),),
                                 (torch.tensor(2.0),))
    shd = protocol.run_sharded(toy_psum, (x,), (np.float32(2.0),),
                               mesh=mesh)
    assert shd.shape == (1,)
    np.testing.assert_array_equal(shd[0], sim.numpy())


def test_run_sharded_matches_run_simulated_three_parties(pool):
    """Three ranks: every party holds the simulated sum, bit for bit."""
    x = (np.arange(24, dtype=np.float32).reshape(3, 8) - 7.5) / 3.0
    sim = protocol.run_simulated(toy_psum, (torch.as_tensor(x),),
                                 (torch.tensor(2.0),))
    shd = protocol.run_sharded(toy_psum, (x,), (np.float32(2.0),),
                               mesh=pool["1x3"])
    for row in shd:
        np.testing.assert_array_equal(row, sim.numpy())
    # a shared operand reaches every rank whole, as a host array
    rep = protocol.replicate_to_mesh(torch.tensor(2.0), pool["1x3"].mesh)
    assert isinstance(rep, np.ndarray) and rep == np.float32(2.0)


def test_closures_have_no_rank_body(pool):
    with pytest.raises(NotImplementedError, match="no rank body"):
        protocol.sharded_program(lambda x: x, pool["1x3"], 1, 0)


# ------------------------------------------------------------------ the fit
def test_sharded_fit_equals_jax_and_port_simulated(pool):
    """A (1, 3) mesh: the classification forest equals the JAX package's
    simulated substrate and the port's, all seven fields; predictions
    (compact and dense) and served answers equal; each rank ran
    2 x trees x depth collective rounds, none staged on the CPU."""
    x, y = make_classification(400, 9, 2, seed=5)
    p = ForestParams(n_estimators=3, max_depth=4, n_bins=8, seed=2)
    sim = _sim(3, n_bins=8)
    sim.ingest(x[:300], y[:300])
    ref = sim.fit(p)
    fed = _fed(pool, "1x3", n_bins=8)
    fed.ingest(x[:300], y[:300])
    before = _rank_counts(fed, "sharded.rounds")
    model = fed.fit(p)
    after = _rank_counts(fed, "sharded.rounds")
    assert [b - a for a, b in zip(before, after)] \
        == [2 * p.n_estimators * p.max_depth] * 3
    assert _rank_counts(fed, "sharded.staged_bytes") == [0, 0, 0]
    assert model.trees_.is_leaf.device == torch.device("cpu")
    _trees_equal(model.trees_, ref.trees_)
    jfed = JFederation(parties=3, n_bins=8)
    jfed.ingest(x[:300], y[:300])
    jref = jfed.fit(JParams(n_estimators=3, max_depth=4, n_bins=8, seed=2))
    got = convert.party_trees_to_numpy(model.trees_)
    assert len(got) == 7
    for f in got:
        np.testing.assert_array_equal(got[f],
                                      np.asarray(getattr(jref.trees_, f)),
                                      err_msg=f)
    xt = x[300:]
    want = sim.predict(ref, xt)
    np.testing.assert_array_equal(fed.predict(model, xt), want)
    np.testing.assert_array_equal(model.predict(xt), ref.predict(xt))
    np.testing.assert_array_equal(np.asarray(jfed.predict(jref, xt)), want)
    server = fed.serve(model, ServeConfig(buckets=(16, 64)))
    assert server.substrate is fed.substrate
    np.testing.assert_array_equal(server.serve(xt), want)
    np.testing.assert_array_equal(server.serve(xt[:10]), want[:10])
    assert server.compile_count == 2               # one bind per bucket
    np.testing.assert_array_equal(model.predict_classical(xt), want)


@pytest.mark.parametrize("variant", sorted(HIST_SUB))
@pytest.mark.parametrize("grid", ["1x2", "2x2"])
def test_hist_subtraction_on_ranks_equals_simulated(pool, grid, variant):
    """``hist_subtraction`` (alone, and with a multi-pass frontier) on a
    rank: the PartyTree equals the simulated fit's in all seven fields, and
    the plain fit's (integer counts make the subtraction exact); each rank
    ran the plain fit's collective rounds."""
    x, y = make_classification(320, 8, 2, seed=13)
    p = ForestParams(n_estimators=2, max_depth=4, n_bins=8, seed=5,
                     **HIST_SUB[variant])
    sim = _sim(2, n_bins=8)
    sim.ingest(x, y)
    ref = sim.fit(p)
    plain = sim.fit(ForestParams(n_estimators=2, max_depth=4, n_bins=8,
                                 seed=5))
    fed = _fed(pool, grid, n_bins=8)
    fed.ingest(x, y)
    before = _rank_counts(fed, "sharded.rounds")
    model = fed.fit(p)
    after = _rank_counts(fed, "sharded.rounds")
    n_shards = GRIDS[grid][0]
    assert [b - a for a, b in zip(before, after)] \
        == [2 * (p.n_estimators // n_shards) * p.max_depth] * (2 * n_shards)
    assert len(convert.party_trees_to_numpy(model.trees_)) == 7
    _trees_equal(model.trees_, ref.trees_)
    _trees_equal(model.trees_, plain.trees_)
    np.testing.assert_array_equal(fed.predict(model, x[:64]),
                                  sim.predict(ref, x[:64]))


@pytest.mark.parametrize("task", ["classification", "regression"])
@pytest.mark.parametrize("grid", ["1x2", "2x2"])
def test_predict_classical_on_ranks_equals_predict(pool, grid, task):
    """The multi-round baseline on the ranks (one party sum per level, rank
    to rank; the forest vote in the session) equals ``predict`` and the
    simulated substrate's classical predict, bit for bit; each rank ran
    ``max_depth`` rounds."""
    if task == "classification":
        x, y = make_classification(300, 8, 3, seed=17)
        p = ForestParams(n_estimators=4, n_classes=3, max_depth=4, n_bins=8,
                         seed=6)
    else:
        x, y = make_regression(300, 8, seed=17)
        p = ForestParams(task="regression", n_estimators=4, max_depth=4,
                         n_bins=8, seed=6)
    sim = _sim(2, n_bins=8)
    sim.ingest(x[:240], y[:240])
    ref = sim.fit(p)
    fed = _fed(pool, grid, n_bins=8)
    fed.ingest(x[:240], y[:240])
    model = fed.fit(p)
    xt = x[240:]
    before = _rank_counts(fed, "sharded.rounds")
    got = model.predict_classical(xt)
    after = _rank_counts(fed, "sharded.rounds")
    assert [b - a for a, b in zip(before, after)] \
        == [p.max_depth] * fed.substrate.mesh.size
    np.testing.assert_array_equal(got, model.predict(xt))
    np.testing.assert_array_equal(got, ref.predict_classical(xt))
    np.testing.assert_array_equal(got, ref.predict(xt))


def test_party_processes_still_refuse_hist_subtraction():
    """A party process's fit body refuses ``hist_subtraction``, as the JAX
    package's does; only a rank (a ``DistComm``) runs it."""
    from repro_torch.federation import distributed
    p = ForestParams(n_estimators=1, max_depth=2, n_bins=8,
                     hist_subtraction=True)
    with pytest.raises(NotImplementedError, match="hist_subtraction"):
        distributed._forest_fit_body(
            distributed.Comm(None, 0, 0, 2),
            distributed.forest_fit_spec(p)["payload"], *(None,) * 5)


def test_sharded_regression_same_splits(pool):
    x, y = make_regression(300, 8, seed=3)
    p = ForestParams(task="regression", n_estimators=2, max_depth=4,
                     n_bins=8, seed=4)
    sim = _sim(3, n_bins=8)
    sim.ingest(x, y)
    ref = sim.fit(p)
    fed = _fed(pool, "1x3", n_bins=8)
    fed.ingest(x, y)
    model = fed.fit(p)
    _trees_equal(model.trees_, ref.trees_,
                 ("is_leaf", "has_split", "split_floc", "split_bin",
                  "owner", "split_gid"))
    np.testing.assert_allclose(
        convert.party_trees_to_numpy(model.trees_)["leaf_stats"],
        convert.party_trees_to_numpy(ref.trees_)["leaf_stats"], rtol=1e-6)


def test_tree_parallel_fit_equals_simulated(pool):
    """A (2, 2) mesh splits the trees over two shards of two parties: the
    PartyTree stack equals the JAX package's simulated substrate's and the
    port's, and so do predictions and served answers; each rank builds its
    shard's trees alone."""
    x, y = make_classification(360, 8, 3, seed=7)
    p = ForestParams(n_estimators=4, n_classes=3, max_depth=4, n_bins=8,
                     seed=3)
    sim = _sim(2, n_bins=8)
    sim.ingest(x[:280], y[:280])
    ref = sim.fit(p)
    fed = _fed(pool, "2x2", n_bins=8)
    fed.ingest(x[:280], y[:280])
    before = _rank_counts(fed, "sharded.rounds")
    model = fed.fit(p)
    after = _rank_counts(fed, "sharded.rounds")
    # each rank builds its tree shard's two of the four trees
    assert [b - a for a, b in zip(before, after)] == [2 * 2 * p.max_depth] * 4
    _trees_equal(model.trees_, ref.trees_)
    jfed = JFederation(parties=2, n_bins=8)
    jfed.ingest(x[:280], y[:280])
    jref = jfed.fit(JParams(n_estimators=4, n_classes=3, max_depth=4,
                            n_bins=8, seed=3))
    got = convert.party_trees_to_numpy(model.trees_)
    for f in got:
        np.testing.assert_array_equal(got[f],
                                      np.asarray(getattr(jref.trees_, f)),
                                      err_msg=f)
    xt = x[280:]
    want = sim.predict(ref, xt)
    np.testing.assert_array_equal(fed.predict(model, xt), want)
    np.testing.assert_array_equal(model.predict(xt), ref.predict(xt))
    server = fed.serve(model, ServeConfig(buckets=(32,)))
    np.testing.assert_array_equal(server.serve(xt), want)
    with pytest.raises(ValueError, match="do not split"):
        fed.fit(ForestParams(n_estimators=3, n_classes=3, max_depth=2,
                             n_bins=8))


def test_boosting_on_trees_mesh_not_tree_sharded(pool):
    """Boosting fits one tree a round: on a (2, 1) mesh its per-round args
    stay replicated over "trees" (``tree_sharded=False``, the JAX test's
    case) and the model equals the simulated one, served too."""
    x, y = make_regression(200, 6, seed=0)
    bp = BoostParams(n_rounds=2, max_depth=2, n_bins=8)
    fed = _fed(pool, "2x1", n_bins=8)
    fed.ingest(x, y)
    bm = fed.fit(bp)
    assert fed.predict(bm, x[:32]).shape == (32,)
    sim = _sim(1, n_bins=8)
    sim.ingest(x, y)
    ref = sim.fit(bp)
    for a, b in zip(bm.trees_, ref.trees_):
        _trees_equal(a, b)
    np.testing.assert_array_equal(fed.predict(bm, x), sim.predict(ref, x))
    server = fed.serve(bm, ServeConfig(buckets=(64,)))
    np.testing.assert_array_equal(server.serve(x[:64]),
                                  sim.serve(ref, ServeConfig(
                                      buckets=(64,))).serve(x[:64]))


def test_flr_on_ranks_labels_equal(pool):
    """F-LR trains on the ranks (one party sum per step) and predicts
    through the distributed substrate's body: labels equal the simulated
    substrate's."""
    x, y = make_classification(300, 9, 2, seed=11)
    lp = LinearParams(steps=60)
    fed = _fed(pool, "1x3", n_bins=8)
    fed.ingest(x, y)
    model = fed.fit(lp)
    sim = _sim(3, n_bins=8)
    sim.ingest(x, y)
    ref = sim.fit(lp)
    np.testing.assert_allclose(model._w.numpy(), ref._w.numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(fed.predict(model, x), sim.predict(ref, x))


def test_party_first_ingest_fit_and_block_serving(pool):
    """Party-first blocks ingested in the session feed the sharded fit:
    equal to the pre-aligned matrix's forest, predictions too, and
    party-block serving re-aligns out-of-order, superset request blocks
    (tests/test_partyblock.py's sharded script)."""
    x, y = make_classification(240, 9, 2, seed=5)
    blocks, xa, ya = make_party_views(x, y, 3, overlap=0.8, seed=5)
    p = ForestParams(n_estimators=2, max_depth=4, n_bins=8, seed=3)
    fed = _fed(pool, "1x3", n_bins=8)
    part = fed.ingest(blocks, validate=True)
    model = fed.fit(p)
    central = _fed(pool, "1x3", n_bins=8)
    central.ingest(xa, ya)
    cmodel = central.fit(p)
    _trees_equal(model.trees_, cmodel.trees_)
    xt = xa[:32]
    np.testing.assert_array_equal(fed.predict(model, xt),
                                  central.predict(cmodel, xt))
    server = fed.serve(model, ServeConfig(buckets=(32,)))
    qids = np.array([f"q{i}" for i in range(len(xt))])
    rng = np.random.default_rng(0)
    req = []
    for i, name in enumerate(part.party_names):
        gid = part.feat_gid[i][part.feat_gid[i] >= 0]
        rows = rng.permutation(len(xt))
        extra = rng.normal(size=(3, len(gid)))
        req.append(PartyBlock(
            name=name, x=np.concatenate([xt[rows][:, gid], extra]),
            ids=np.concatenate([qids[rows],
                                [f"{name}-{j}" for j in range(3)]])))
    ids, preds = server.serve_parties(req)
    order = np.argsort(crypto.hash_ids(qids))
    np.testing.assert_array_equal(ids, qids[order])
    np.testing.assert_array_equal(preds, cmodel.predict(xt[order]))


# ------------------------------------------------------------------ servers
def test_server_on_a_mesh_of_its_own():
    """``ForestServer.from_forest(ff, mesh=1x1)``: a one-party forest
    served on a one-rank mesh equals its predict, compile-once per bucket
    (tests/test_serving.py's twin); ``close()`` stops the server's rank."""
    x, y = make_classification(400, 12, 2, seed=21)
    p = ForestParams(n_estimators=3, max_depth=5, n_bins=16, seed=22)
    sim = _sim(1, n_bins=16)
    sim.ingest(x[:300], y[:300])
    ff = sim.fit(p)
    mesh = mesh_mod.make_host_mesh(1, axes=("trees", "parties"),
                                   shape=(1, 1))
    server = ForestServer.from_forest(ff, mesh=mesh, buckets=(32, 64))
    try:
        assert server.substrate.name == "sharded"
        server.warmup()
        np.testing.assert_array_equal(server.serve(x[300:]),
                                      ff.predict(x[300:]))
        assert server.compile_count == 2
    finally:
        server.close()
    assert server.substrate._coord is None


def test_from_checkpoint_with_mesh_derives_party_count(tmp_path):
    """``ForestServer.from_checkpoint(mesh=)`` takes M from the
    checkpointed stack; a mesh whose "parties" axis disagrees is refused
    before anything is spawned."""
    x, y = make_classification(300, 10, 2, seed=31)
    p = ForestParams(n_estimators=2, max_depth=4, n_bins=8, seed=32)
    fed = _sim(1, n_bins=8)
    part = fed.ingest(x[:250], y[:250])
    model = fed.fit(p)
    fed.save(model, str(tmp_path))
    with pytest.raises(ValueError, match="executes"):
        ForestServer.from_checkpoint(
            str(tmp_path), p, device="cpu",
            mesh=mesh_mod.make_host_mesh(2), partition=part, buckets=(32,))
    server = ForestServer.from_checkpoint(
        str(tmp_path), p, device="cpu",
        mesh=mesh_mod.make_host_mesh(1, shape=(1, 1)), partition=part,
        buckets=(32,))
    try:
        assert server.n_parties == 1 and server.substrate.n_parties == 1
        np.testing.assert_array_equal(server.serve(x[250:]),
                                      model.predict(x[250:]))
    finally:
        server.close()


# --------------------------------------------------------------- refusals
def test_validation():
    with pytest.raises(ValueError, match="mesh"):
        Federation(parties=2, substrate="sharded", device="cpu")
    with pytest.raises(ValueError, match="unknown substrate"):
        resolve_substrate("warp-drive")
    with pytest.raises(ValueError, match="executes 3 parties"):
        Federation(parties=2, substrate="sharded",
                   mesh=mesh_mod.make_host_mesh(3), device="cpu")
    with pytest.raises(ValueError, match="'parties' mesh axis"):
        ShardedSubstrate(object(), device="cpu")


def test_no_backend_or_device_fallback():
    """NCCL with two ranks on one card is refused when the mesh is made,
    before anything is spawned; NCCL on CPU ranks too; a mesh on the card
    does not serve a CPU session (nor the other way round)."""
    with pytest.raises(ValueError, match="distinct card per rank"):
        mesh_mod.make_forest_mesh(parties=2, backend="nccl",
                                  devices="cuda:0")
    with pytest.raises(ValueError, match="cards only"):
        mesh_mod.make_forest_mesh(parties=2, backend="nccl", devices="cpu")
    with pytest.raises(ValueError, match="backend"):
        mesh_mod.make_forest_mesh(parties=2, backend="mpi", devices="cpu")
    card = mesh_mod.make_forest_mesh(parties=2, devices="cuda:0")
    assert card.devices == ("cuda:0", "cuda:0") and card.backend == "gloo"
    with pytest.raises(ValueError, match="ranks run on cuda"):
        ShardedSubstrate(card, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh_mod.make_forest_mesh(parties=2)
