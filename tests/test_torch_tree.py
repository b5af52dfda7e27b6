"""Tree building in the PyTorch port (on the CPU) against the JAX
package's simulated fit, on the same seeded data, partition and params.

Classification: every sum is of integers, so all seven PartyTree fields
must be bit-identical, on every build path.  Regression: the same splits on
fixtures without near-ties, and leaf stats within rtol 1e-5 (float sums may
associate differently across frameworks).  Inside the port, the paper's
losslessness FF(M) == FF(1) holds bit for bit on both tasks."""
import functools

import numpy as np
import pytest

from repro.core.forest import FederatedForest as JForest
from repro.core.party import make_vertical_partition as j_make_partition
from repro.core.types import ForestParams as JParams
from repro_torch import convert
from repro_torch.core.forest import FederatedForest
from repro_torch.core.party import make_vertical_partition
from repro_torch.core.types import ForestParams
from repro_torch.data import make_classification, make_regression

SPLIT_FIELDS = ("is_leaf", "has_split", "split_floc", "split_bin", "owner",
                "split_gid")
VARIANTS = {
    "dense": {"frontier_cap": 0},
    "frontier_multipass": {"frontier_cap": 3},
    "hist_subtraction": {"hist_subtraction": True, "frontier_cap": 0},
    "trees_per_batch_1": {"trees_per_batch": 1},
    "trees_per_batch_3": {"trees_per_batch": 3},
}


@functools.lru_cache(maxsize=None)
def _data(task):
    if task == "classification":
        return make_classification(1200, 13, 2, n_informative=5, seed=0)
    # a seed whose trees meet no near-tie: at small nodes several features
    # can cut the same samples, a tie in real arithmetic that each
    # framework's float32 prefix sums break their own way (XLA's cumsum
    # associates by bin position, PyTorch's runs sequentially)
    return make_regression(1200, 13, seed=2)


def _params(task, **kw):
    base = dict(task=task, n_estimators=3, max_depth=5, n_bins=16, seed=7)
    base.update(kw)
    return base


@functools.lru_cache(maxsize=None)
def _jax_fit(task, m, variant):
    x, y = _data(task)
    part = j_make_partition(x, m, 16)
    model = JForest(JParams(**_params(task, **VARIANTS[variant]))).fit(part, y)
    return {f: np.asarray(getattr(model.trees_, f)) for f in SPLIT_FIELDS
            + ("leaf_stats",)}


def _port_fit(task, m, **kw):
    x, y = _data(task)
    part = make_vertical_partition(x, m, 16)
    model = FederatedForest(ForestParams(**_params(task, **kw)),
                            device="cpu").fit(part, y)
    return model, convert.party_trees_to_numpy(model.trees_)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_classification_trees_bit_identical_to_jax(variant):
    want = _jax_fit("classification", 2, variant)
    _, got = _port_fit("classification", 2, **VARIANTS[variant])
    assert got["is_leaf"].shape == (2, 3, 63)
    for f, a in want.items():
        np.testing.assert_array_equal(got[f], a, err_msg=f)


@pytest.mark.parametrize("variant", ["dense", "frontier_multipass"])
def test_regression_same_splits_as_jax(variant):
    want = _jax_fit("regression", 2, variant)
    _, got = _port_fit("regression", 2, **VARIANTS[variant])
    for f in SPLIT_FIELDS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    np.testing.assert_allclose(got["leaf_stats"], want["leaf_stats"],
                               rtol=1e-5, atol=0)


@pytest.mark.parametrize("m", [2, 3])
@pytest.mark.parametrize("task", ["classification", "regression"])
def test_lossless_inside_port(task, m):
    """FF(M) == FF(1): the master view (structure, stats, encoded feature
    ids) and the predictions are bit-identical to the centralized forest."""
    central, c = _port_fit(task, 1, frontier_cap=4)
    fed, f = _port_fit(task, m, frontier_cap=4)
    for field in ("is_leaf", "leaf_stats", "split_gid"):
        np.testing.assert_array_equal(f[field][0], c[field][0], err_msg=field)
    # every party holds the same shared structure; each split has one owner
    assert (f["is_leaf"] == f["is_leaf"][:1]).all()
    np.testing.assert_array_equal(f["has_split"].sum(0), f["owner"][0] >= 0)
    x, _ = _data(task)
    np.testing.assert_array_equal(fed.predict(x[:300]), central.predict(x[:300]))


@pytest.mark.parametrize("task", ["classification", "regression"])
def test_frontier_equals_dense_inside_port(task):
    """Frontier compaction only re-indexes histogram rows, so any cap
    builds the dense forest bit for bit; hist_subtraction does too for
    classification (integer counts), while for regression it reorders float
    sums and is only a statistically equivalent variant, as in JAX."""
    _, dense = _port_fit(task, 2, frontier_cap=0)
    variants = [{"frontier_cap": 1}, {"frontier_cap": 5}]
    if task == "classification":
        variants.append({"hist_subtraction": True, "frontier_cap": 0})
    for kw in variants:
        _, other = _port_fit(task, 2, **kw)
        for f, a in dense.items():
            np.testing.assert_array_equal(other[f], a, err_msg=f"{kw} {f}")


def _tree_inputs(task, m, seed=11):
    """A fit's folded bins, feature ids, stats and per-tree draws (some
    features left out of each tree, rows drawn with repeats)."""
    import torch
    from repro_torch.core import impurity, tree
    x, y = _data(task)
    part = make_vertical_partition(x, m, 16)
    rng = np.random.default_rng(seed)
    n, f = part.n_samples, part.n_features
    weights = torch.as_tensor(np.stack([
        np.bincount(rng.integers(0, n, n), minlength=n) for _ in range(3)]),
        dtype=torch.float32)
    sels = torch.as_tensor(np.stack([rng.random(f) < 0.7 for _ in range(3)]))
    return (tree.fold_parties(torch.as_tensor(part.xb)),
            torch.as_tensor(part.feat_gid).to(torch.int32), sels, weights,
            impurity.stat_channels(torch.as_tensor(y), task, 2))


@pytest.mark.parametrize("variant", ["dense", "frontier_multipass",
                                     "hist_subtraction"])
@pytest.mark.parametrize("task", ["classification", "regression"])
def test_one_state_grows_tree_after_tree(task, variant):
    """The level loop writes in place into one ``TreeState``, as the card's
    graphs do: grown tree after tree in that one state (out of order, one
    tree twice), each tree equals the one ``build_tree`` grows afresh, so
    no tree reads what the last one left."""
    import torch
    from repro_torch.core import tree
    p = ForestParams(**_params(task, **VARIANTS[variant]))
    xb, gid, sels, weights, stats = _tree_inputs(task, 2)
    fresh = [tree.build_tree(xb, gid, sels[t], weights[t], stats, p, tree=t)
             for t in range(3)]
    sel, w = torch.empty_like(sels[0]), torch.empty_like(weights[0])
    st = tree.TreeState(xb, gid, sel, w, stats, p, "auto",
                        torch.arange(2, dtype=torch.int32))
    for t in (2, 0, 1, 2):
        sel.copy_(sels[t])
        w.copy_(weights[t])
        tree._grow(st, t)
        for name, a, b in zip(tree.PartyTree._fields, st.tree(), fresh[t]):
            assert torch.equal(a, b), (t, name)


def test_graph_rule_keeps_cpu_comm_and_dispatch_modes_eager():
    """The level graphs are for CUDA tensors in process outside any
    dispatch mode alone: a fit on CPU tensors, and a fit and a party's
    build with a ``comm`` under ``FakeTensorMode`` on the dry run's device
    (CUDA where PyTorch is built for it), capture nothing and leave the
    graph cache as it was; a (fake) CUDA tensor is refused inside the mode
    and with a ``comm``."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch import op_analysis
    from repro_torch.core import tree, tree_graphs
    from repro_torch.launch import cases
    from repro_torch.observability.registry import REGISTRY
    captures = REGISTRY.counter("forest.graph_captures")
    c0, n0 = captures.value, len(tree_graphs._CACHE)
    p = ForestParams(**_params("classification", frontier_cap=0))
    xb, gid, sels, weights, stats = _tree_inputs("classification", 2)
    assert not tree._on_graphs(xb, None)
    _port_fit("classification", 2, frontier_cap=0)
    specs = [((2, xb.shape[0], gid.shape[1]), xb.dtype)] + [
        (a.shape, a.dtype) for a in (gid, sels, weights, stats)]
    with FakeTensorMode():
        fcuda = torch.zeros(4, device="cuda")
        assert fcuda.is_cuda and not tree._on_graphs(fcuda, None)
        # the dry run's device: CUDA where PyTorch is built for it
        fx, fgid, fsel, fw, fst = (
            torch.zeros(shape, dtype=dt, device=cases.FAKE_DEVICE)
            for shape, dt in specs)
        forest = tree.build_forest(fx, fgid, fsel, fw, fst, p)
        assert forest.is_leaf.shape == (2, 3, 63)
        comm = op_analysis.FakeComm((0, 1), 0, op_analysis.CollectiveTally(),
                                    device=cases.FAKE_DEVICE)
        tree.build_tree(tree.fold_parties(fx[:1]), fgid[:1], fsel[0], fw[0],
                        fst, p, comm=comm)
    # outside the mode a (fake) CUDA tensor alone would replay; with a
    # comm it would not
    assert tree._on_graphs(fcuda, None) and not tree._on_graphs(fcuda, comm)
    assert (captures.value, len(tree_graphs._CACHE)) == (c0, n0)
