"""The plain reference against the port on the CPU: the same bins, the
same trees (classification bit for bit; a regression fixture without
near-ties to the same splits, stats within float32 rounding), the same
answers as ``fed.predict`` and as the serving queue, and a replay of the
port's own forest that reads nothing wrong."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from bench.drivers.common import party_groups
from bench.reference import forest as ref
from repro_torch.core import ForestParams
from repro_torch.data import make_classification, make_regression
from repro_torch.federation import Federation
from repro_torch.serving import RequestQueue, ServeConfig

FIXTURES = {
    # (task, data, forest): the regression fixture's seed was picked for
    # having no near-tie between candidates under the reference's exact
    # sums (seed 2, the port's own CPU fixture, meets an exact tie of two
    # features, which the port's float32 sums break the other way)
    "classification": ("classification",
                       lambda: make_classification(3000, 12, 2, seed=3),
                       dict(n_estimators=4, max_depth=5, n_bins=16, seed=11)),
    "regression": ("regression", lambda: make_regression(1200, 13, seed=4),
                   dict(n_estimators=3, max_depth=5, n_bins=16, seed=7)),
}


def _fit(name, parties=2, **over):
    task, data, kw = FIXTURES[name]
    x, y = data()
    params = ForestParams(task=task, **{**kw, **over})
    fed = Federation(parties=parties, n_bins=params.n_bins, device="cpu")
    part = fed.ingest(x, y)
    model = fed.fit(params)
    p = ref.Forest(task=task, n_classes=2 if task == "classification" else 0,
                   n_estimators=params.n_estimators,
                   max_depth=params.max_depth, n_bins=params.n_bins,
                   seed=params.seed)
    return x, y, fed, part, model, p


def _program_trees(model, part, n_features):
    groups = [g[g >= 0] for g in part.feat_gid]
    out = []
    for t in range(model.trees_.is_leaf.shape[1]):
        fields = {k: getattr(model.trees_, k)[:, t].numpy()
                  for k in model.trees_._fields}
        tree, bad = ref.master_view(fields, groups, n_features)
        assert bad == 0
        out.append(tree)
    return out


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_bins_equal_the_programs(name):
    x, _, _, part, _, p = _fit(name)
    edges = ref.quantile_edges(x, p.n_bins)
    assert np.array_equal(edges, part.boundaries)
    xb = ref.bin_rows(x, edges, "cpu").numpy()
    for i, g in enumerate(part.feat_gid):
        g = g[g >= 0]
        assert np.array_equal(xb[:, g], part.xb[i, :, :len(g)])


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_reference_grows_the_same_trees(name):
    x, y, _, part, model, p = _fit(name)
    xb = ref.bin_rows(x, ref.quantile_edges(x, p.n_bins), "cpu")
    mine = ref.grow_forest(xb, y, p)
    theirs = _program_trees(model, part, x.shape[1])
    for a, b in zip(mine, theirs):
        assert np.array_equal(a.is_leaf, b.is_leaf)
        assert np.array_equal(a.split_gid, b.split_gid)
        assert np.array_equal(a.split_bin, b.split_bin)
        if p.task == "classification":
            assert np.array_equal(a.node_stats, b.node_stats)
        else:
            scale = np.abs(a.node_stats).max(0)
            assert np.all(np.abs(a.node_stats - b.node_stats)
                          <= 1e-5 * scale)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_reference_answers_as_fed_predict(name):
    x, y, fed, part, model, p = _fit(name)
    edges = ref.quantile_edges(x, p.n_bins)
    trees = ref.grow_forest(ref.bin_rows(x, edges, "cpu"), y, p)
    x_new = x[::7] + 0.01
    want = fed.predict(model, x_new)
    got = ref.predict(trees, ref.bin_rows(x_new, edges, "cpu"), p)
    if p.task == "classification":
        assert np.array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_reference_answers_as_the_serving_queue():
    x, y, fed, part, model, p = _fit("classification")
    edges = ref.quantile_edges(x, p.n_bins)
    trees = ref.grow_forest(ref.bin_rows(x, edges, "cpu"), y, p)
    server = fed.serve(model, ServeConfig(buckets=(8, 64), max_inflight=2))
    q = RequestQueue(server)
    sizes = [1, 9, 63, 64, 99, 5]
    starts = np.cumsum([0] + sizes[:-1])
    rids = [q.submit(x[s:s + k]) for s, k in zip(starts, sizes)]
    out = q.drain()
    for rid, s, k in zip(rids, starts, sizes):
        want = ref.predict(trees, ref.bin_rows(x[s:s + k], edges, "cpu"), p)
        assert np.array_equal(out[rid], want)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_replay_of_the_programs_forest_reads_nothing_wrong(name):
    x, y, _, part, model, p = _fit(name)
    xb = ref.bin_rows(x, ref.quantile_edges(x, p.n_bins), "cpu")
    stats = ref.label_stats(y, p, "cpu")
    n, f = xb.shape
    total = ref.Reading()
    for t, tree in enumerate(_program_trees(model, part, f)):
        w, sel = ref.master_draws(p, n, f, t)
        total = total.merge(ref.replay_tree(tree, xb, stats, w, sel, p))
    assert total.bad_nodes == 0
    assert total.split_regret < 1e-6
    assert total.stat_err < (1e-12 if p.task == "classification" else 1e-5)


def test_master_view_catches_a_party_that_disagrees():
    x, _, _, part, model, _ = _fit("classification")
    fields = {k: getattr(model.trees_, k)[:, 0].numpy().copy()
              for k in model.trees_._fields}
    groups = [g[g >= 0] for g in part.feat_gid]
    _, bad = ref.master_view(fields, groups, x.shape[1])
    assert bad == 0
    owner = fields["owner"][0, 0]
    fields["split_floc"][owner, 0] += 1
    _, bad = ref.master_view(fields, groups, x.shape[1])
    assert bad == 1


def test_party_groups_follow_the_ports_contiguous_split():
    cfg = {"split": "contiguous", "n_features": 41, "parties": 2}
    x, y = make_classification(50, 41, 2, seed=0)
    part = Federation(parties=2, n_bins=8, device="cpu").ingest(x, y)
    for g, fg in zip(party_groups(cfg), part.feat_gid):
        assert np.array_equal(g, fg[fg >= 0])


def test_bf16_control_grows_other_trees():
    x, y, _, _, _, p = _fit("classification")
    xb = ref.bin_rows(x, ref.quantile_edges(x, p.n_bins), "cpu")
    a = ref.grow_forest(xb, y, p)
    b = ref.grow_forest(xb, y, p, torch.bfloat16)
    assert any(not np.array_equal(s.node_stats, t.node_stats)
               for s, t in zip(a, b))
