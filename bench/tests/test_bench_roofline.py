"""The roofline's counts against hand counts at a tiny shape, and the
count as the algorithm's: a fit with ``hist_subtraction`` (fewer rows
histogrammed by the program) counts the same bytes."""
from __future__ import annotations

import numpy as np
import torch

from bench import roofline
from bench.reference import forest as ref
from repro_torch.core import ForestParams
from repro_torch.data import make_classification
from repro_torch.federation import Federation

P = ref.Forest(task="classification", n_classes=2, n_estimators=1,
               max_depth=2, n_bins=4, bootstrap=False)


def _hand_tree():
    """Root splits feature 0 at bin 1 (rows 0 1 4 5 left), its left child
    feature 1 at bin 1 (rows 0 1 left), its right child is a leaf."""
    xb = torch.tensor([[0, 1], [1, 1], [2, 0], [3, 0],
                       [0, 2], [1, 3], [2, 3], [3, 2]])
    y = np.array([0, 0, 1, 1, 1, 0, 1, 1])
    stats = ref.label_stats(y, P, "cpu")
    nn = P.n_nodes
    is_leaf = np.zeros(nn, bool)
    is_leaf[[2, 3, 4]] = True
    gid = np.full(nn, -1)
    sbin = np.full(nn, -1)
    gid[0], sbin[0], gid[1], sbin[1] = 0, 1, 1, 1
    node_stats = np.zeros((nn, 2))
    for node, rows in {0: range(8), 1: [0, 1, 4, 5], 2: [2, 3, 6, 7],
                       3: [0, 1], 4: [4, 5]}.items():
        node_stats[node] = stats[list(rows)].sum(0).numpy()
    return xb, stats, ref.Tree(is_leaf, node_stats, gid, sbin)


def test_level_counts_by_hand():
    xb, stats, tree = _hand_tree()
    r = ref.replay_tree(tree, xb, stats, np.ones(8), np.ones(2, bool), P)
    assert r.bad_nodes == 0 and r.stat_err == 0.0
    lv = r.counts[0]
    assert [(d["search_rows"], d["search_nodes"], d["split_rows"])
            for d in lv] == [(8, 1, 8), (8, 2, 4), (0, 0, 0)]
    assert [d["live_nodes"] for d in lv] == [1, 2, 2]


def test_bytes_by_hand():
    xb, stats, tree = _hand_tree()
    r = ref.replay_tree(tree, xb, stats, np.ones(8), np.ones(2, bool), P)
    # one level: rows x (F bin bytes + 4-byte node id + C float32 stats)
    # + nodes x F x B x C float32 written
    assert roofline.level_hist_bytes(8, 1, 2, 4, 2) == 8 * 14 + 64
    b = roofline.fit_bytes(r.counts, n_features=2, n_bins=4, n_channels=2)
    assert b == {"hist_bytes": 176 + 240, "route_bytes": 8 + 4,
                 "bytes": 428}
    assert roofline.least_seconds(3.35e12) == 1.0


def test_rows_outside_the_draw_cost_nothing():
    xb, stats, tree = _hand_tree()
    w = np.ones(8)
    w[[0, 5]] = 0
    tree.node_stats[:] = 0
    r = ref.replay_tree(tree, xb, stats, w, np.ones(2, bool), P)
    assert r.counts[0][0]["search_rows"] == 6


def _counts(params, x, y):
    fed = Federation(parties=2, n_bins=params.n_bins, device="cpu")
    part = fed.ingest(x, y)
    model = fed.fit(params)
    p = ref.Forest(task="classification", n_classes=2,
                   n_estimators=params.n_estimators,
                   max_depth=params.max_depth, n_bins=params.n_bins,
                   seed=params.seed)
    xb = ref.bin_rows(x, ref.quantile_edges(x, p.n_bins), "cpu")
    stats = ref.label_stats(y, p, "cpu")
    groups = [g[g >= 0] for g in part.feat_gid]
    trees, n, f = [], *xb.shape
    for t in range(params.n_estimators):
        fields = {k: getattr(model.trees_, k)[:, t].numpy()
                  for k in model.trees_._fields}
        tree, _ = ref.master_view(fields, groups, f)
        w, sel = ref.master_draws(p, n, f, t)
        trees += ref.replay_tree(tree, xb, stats, w, sel, p).counts
    return roofline.fit_bytes(trees, f, p.n_bins, 2), model


def test_hist_subtraction_counts_the_same_bytes():
    x, y = make_classification(2500, 9, 2, seed=5)
    kw = dict(task="classification", n_estimators=3, max_depth=5,
              n_bins=16, seed=3, frontier_cap=0)
    plain, m0 = _counts(ForestParams(**kw), x, y)
    sub, m1 = _counts(ForestParams(hist_subtraction=True, **kw), x, y)
    for a, b in zip(m0.trees_, m1.trees_):
        assert torch.equal(a, b)
    assert plain == sub and plain["bytes"] > 0
