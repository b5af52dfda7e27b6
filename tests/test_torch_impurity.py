"""Impurity and split gains of the PyTorch port against the JAX package:
bit-equal on integer-valued histograms (classification counts, and
regression stats of integer targets), and within 1e-6 on float ones (the
prefix sums over bins may associate differently)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import impurity as jimp
from repro_torch.core import impurity


def _hist(task, c, integer, seed):
    rng = np.random.default_rng(seed)
    shape = (6, 5, 16, c)
    if task == "classification":
        h = rng.integers(0, 40, shape)
        h[0] = 0                                  # an empty node
        h[1, :, 3:] = 0                           # a node in few bins
        return h.astype(np.float32)
    w = rng.integers(0, 5, shape[:3]).astype(np.float32)
    y = (rng.integers(-9, 10, shape[:3]) if integer
         else rng.normal(size=shape[:3])).astype(np.float32)
    return np.stack([w, w * y, w * y * y], -1).astype(np.float32)


@pytest.mark.parametrize("msl", [1, 5])
@pytest.mark.parametrize("task,c", [("classification", 2),
                                    ("classification", 3),
                                    ("regression", 3)])
def test_split_gains_integer_bit_equal(task, c, msl):
    h = _hist(task, c, integer=True, seed=c + msl)
    got = impurity.split_gains(torch.as_tensor(h), task, msl).numpy()
    want = np.asarray(jimp.split_gains(jnp.asarray(h), task, msl))
    assert got.shape == (6, 5, 15) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_split_gains_float_close(seed):
    """A gain is parent - left - right of impurity sums, so float32
    cancellation leaves it an absolute error of a few ulp of the PARENT's
    impurity, whatever the gain's own size: the 1e-6 bound is taken
    relative to the parent impurity."""
    h = _hist("regression", 3, integer=False, seed=seed)
    got = impurity.split_gains(torch.as_tensor(h), "regression", 1).numpy()
    want = np.asarray(jimp.split_gains(jnp.asarray(h), "regression", 1))
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    parent = np.asarray(jimp.impurity_sum(jnp.asarray(h.sum(2)), "regression"))
    scale = np.broadcast_to(np.abs(parent)[:, :, None], want.shape)
    fin = np.isfinite(want)
    assert np.all(np.abs(got[fin] - want[fin]) <= 1e-6 * (1.0 + scale[fin]))


@pytest.mark.parametrize("task", ["classification", "regression"])
def test_stat_helpers_equal(task):
    rng = np.random.default_rng(3)
    y = (rng.integers(0, 3, 50) if task == "classification"
         else rng.normal(size=50))
    got = impurity.stat_channels(torch.as_tensor(y), task, 3).numpy()
    want = np.asarray(jimp.stat_channels(jnp.asarray(y), task, 3))
    np.testing.assert_array_equal(got, want)
    s = _hist(task, 3, integer=True, seed=4)[:, 0, :, :]
    for fn in ("count_of", "impurity_sum", "leaf_value"):
        np.testing.assert_array_equal(
            getattr(impurity, fn)(torch.as_tensor(s), task).numpy(),
            np.asarray(getattr(jimp, fn)(jnp.asarray(s), task)), err_msg=fn)


def _gains_fixed_order(h, msl):
    """NumPy float32 split gains in the port's device-independent order: a
    float64 prefix over bins rounded once, the classes' squares added one
    by one."""
    prefix = np.cumsum(h.astype(np.float64), axis=2).astype(np.float32)

    def imp(s):
        n = s.sum(-1)
        sum_sq = s[..., 0] * s[..., 0]
        for k in range(1, s.shape[-1]):
            sum_sq = sum_sq + s[..., k] * s[..., k]
        return n - sum_sq / np.maximum(n, np.float32(1e-12))

    left, total = prefix[:, :, :-1], prefix[:, :, -1]
    right = total[:, :, None, :] - left
    gain = imp(total)[:, :, None] - imp(left) - imp(right)
    ok = (left.sum(-1) >= msl) & (right.sum(-1) >= msl)
    return np.where(ok, gain, np.float32(-np.inf)).astype(np.float32)


@pytest.mark.parametrize("c", [2, 3, 5, 9])
def test_split_gains_fixed_order_at_large_counts(c):
    """Counts above 2^12 square to inexact float32, where the order of the
    sum over classes shows in the bits: the gains follow the fixed order
    that the card reproduces (tests/test_torch_cuda.py)."""
    h = np.random.default_rng(c).integers(0, 60000, (4, 3, 16, c))
    h = h.astype(np.float32)
    got = impurity.split_gains(torch.as_tensor(h), "classification", 1)
    np.testing.assert_array_equal(got.numpy(), _gains_fixed_order(h, 1))
