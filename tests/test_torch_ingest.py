"""Params and ingest of the PyTorch port, held against the JAX package:
the same seeded NumPy inputs give bit-identical partitions, boundaries,
label codes, data and resolved params."""
import dataclasses

import numpy as np
import pytest

from repro.core import binning as jbinning
from repro.core import crypto as jcrypto
from repro.core.party import make_vertical_partition as j_make_partition
from repro.core.types import ForestParams as JParams
from repro.data import tabular as jtabular
from repro_torch.core import binning, crypto
from repro_torch.core.party import make_vertical_partition
from repro_torch.core.types import ForestParams
from repro_torch.data import tabular


@pytest.mark.parametrize("contiguous", [True, False])
@pytest.mark.parametrize("m", [1, 2, 3])
def test_partition_bit_identical(m, contiguous):
    rng = np.random.default_rng(10 + m)
    x = rng.normal(size=(300, 11))
    x[:, 4] = 2.5                                    # a constant feature
    x[:, 7] = rng.integers(0, 3, size=300)           # heavy ties
    want = j_make_partition(x, m, 16, contiguous=contiguous, seed=3)
    got = make_vertical_partition(x, m, 16, contiguous=contiguous, seed=3)
    assert got.xb.dtype == np.uint8 and got.feat_gid.dtype == np.int32
    np.testing.assert_array_equal(got.xb, want.xb)
    np.testing.assert_array_equal(got.feat_gid, want.feat_gid)
    np.testing.assert_array_equal(got.boundaries, want.boundaries)
    assert got.n_features == want.n_features and got.n_bins == want.n_bins
    x_test = rng.normal(size=(40, 11))
    np.testing.assert_array_equal(got.bin_test(x_test), want.bin_test(x_test))


def test_binning_bit_identical():
    x = np.random.default_rng(0).normal(size=(257, 5))
    for n_bins in (2, 32, 256):
        xb, b = binning.bin_dataset(x, n_bins)
        jxb, jb = jbinning.bin_dataset(x, n_bins)
        np.testing.assert_array_equal(xb, jxb)
        np.testing.assert_array_equal(b, jb)


@pytest.mark.parametrize("n", [50, 2000, 117148])
def test_params_resolved_equal(n):
    for kw in ({}, {"frontier_cap": "auto", "trees_per_batch": "auto"},
               {"task": "regression", "n_bins": 64, "max_depth": 10,
                "frontier_cap": "auto", "trees_per_batch": "auto"}):
        got, want = ForestParams(**kw).resolved(n), JParams(**kw).resolved(n)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert (got.n_nodes, got.max_leaves, got.n_stat_channels) == \
            (want.n_nodes, want.max_leaves, want.n_stat_channels)
        assert got.level_slice(3) == want.level_slice(3)


def test_params_fields_and_validation():
    assert [f.name for f in dataclasses.fields(ForestParams)] == \
        [f.name for f in dataclasses.fields(JParams)]
    for bad in ({"n_bins": 0}, {"max_depth": 0}, {"task": "ranking"},
                {"max_features": 0.0}, {"frontier_cap": -1},
                {"frontier_cap": "wide"}, {"trees_per_batch": 0}):
        with pytest.raises(ValueError):
            ForestParams(**bad)


def test_crypto_bit_identical():
    ids = np.arange(40)
    np.testing.assert_array_equal(crypto.hash_ids(ids, salt="s"),
                                  jcrypto.hash_ids(ids, salt="s"))
    a = crypto.hash_ids(np.arange(0, 30))
    b = crypto.hash_ids(np.arange(10, 40)[::-1])
    for got, want in zip(crypto.align_ids(a, b), jcrypto.align_ids(a, b)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="duplicate"):
        crypto.align_ids(np.array(["x", "x"]))
    with pytest.raises(ValueError, match="empty"):
        crypto.align_ids(np.array(["x"]), np.array(["y"]))

    y = np.random.default_rng(1).integers(0, 4, 50)
    enc, dec = crypto.encode_labels(y, 4, seed=5)
    jenc, _ = jcrypto.encode_labels(y, 4, seed=5)
    np.testing.assert_array_equal(enc, jenc)
    np.testing.assert_array_equal(dec(enc), y)
    np.testing.assert_array_equal(crypto.label_decoder(4, 5)(enc), y)

    yr = np.random.default_rng(2).normal(size=30)
    m, unmask = crypto.mask_regression_targets(yr, seed=6)
    jm, _ = jcrypto.mask_regression_targets(yr, seed=6)
    np.testing.assert_array_equal(m, jm)
    np.testing.assert_allclose(unmask(m), yr, rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(crypto.regression_unmasker(6)(m),
                                  jcrypto.regression_unmasker(6)(m))


def test_data_generators_bit_identical():
    for got, want in (
            (tabular.make_classification(200, 9, 3, n_informative=4, seed=2),
             jtabular.make_classification(200, 9, 3, n_informative=4, seed=2)),
            (tabular.make_regression(200, 9, seed=2),
             jtabular.make_regression(200, 9, seed=2))):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    x, y = tabular.make_classification(100, 5, seed=0)
    for a, b in zip(tabular.train_test_split(x, y, 0.25, seed=1),
                    jtabular.train_test_split(x, y, 0.25, seed=1)):
        np.testing.assert_array_equal(a, b)
