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
