"""The port's F-LR (federated logistic / linear regression) against the
JAX package's, on the CPU; plus twins of tests/test_substrate.py's F-LR,
mask, Z-test and F1 tests, and the dataset helpers.

400 float32 steps sum their products in another order in torch than in
XLA, so weights and joint logits are held with allclose.  Measured on the
classification fixture below (``make_classification(600, 20, 2, seed=4)``,
3 parties, 500 training rows): the weights differ by at most 2.4e-7 on
magnitudes up to 1.38.  The stated tolerance is rtol 1e-5, atol 1e-6.
Binary predictions must be equal except on rows whose |logit| is below
that tolerance; the test counts them.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import crypto as jcrypto
from repro.core.fedlinear import FederatedLinear as JLinear
from repro.data import tabular as jtabular
from repro.federation import programs as jprograms
from repro.federation.substrate import SimulatedSubstrate as JSimulated
from repro_torch.core import FederatedLinear, LinearParams, crypto
from repro_torch.core.fedlinear import split_columns
from repro_torch.data import (DATASETS, accuracy, f1_binary, load_dataset,
                              make_classification, make_regression, rmse,
                              ztest_two_sample)
from repro_torch.federation import Federation, programs
from repro_torch.federation.substrate import SimulatedSubstrate

RTOL, ATOL = 1e-5, 1e-6


@functools.lru_cache(maxsize=None)
def _fits(task):
    if task == "classification":
        x, y = make_classification(600, 20, 2, seed=4)
        kw = {}
    else:
        x, y = make_regression(600, 15, nonlinear=False, noise=0.1, seed=5)
        kw = dict(task="regression", lr=0.3, steps=600)
    blocks = split_columns(x[:500], 3)
    return (x, y, JLinear(**kw).fit(blocks, y[:500]),
            FederatedLinear(device="cpu", **kw).fit(blocks, y[:500]))


def _logits(jmodel, model, x):
    """Each package's joint logit z = Σ_i x_i w_i + b from its own
    predict program (the regression form of the program is z itself)."""
    blocks = split_columns(x, 3)
    jfn = jax.jit(jprograms.linear_predict_program(JSimulated(), "regression"))
    jz = jprograms.party0(jfn(jnp.asarray(jmodel._standardized(blocks)),
                              jmodel._w, jmodel._b[0]))
    run = programs.linear_predict_program(SimulatedSubstrate(), "regression")
    z = programs.party0(run(torch.as_tensor(model._standardized(blocks)),
                            model._w, model._b[0]))
    return z, jz


@pytest.mark.parametrize("task", ["classification", "regression"])
def test_weights_and_logits_allclose_to_jax(task):
    x, y, jmodel, model = _fits(task)
    assert model._w.shape == jmodel._w.shape == (3, {"classification": 7,
                                                     "regression": 5}[task])
    assert model._b.shape == jmodel._b.shape == (3,)
    np.testing.assert_allclose(model._w.numpy(), np.asarray(jmodel._w),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(model._b.numpy(), np.asarray(jmodel._b),
                               rtol=RTOL, atol=ATOL)
    z, jz = _logits(jmodel, model, x[500:])
    np.testing.assert_allclose(z, jz, rtol=RTOL, atol=ATOL)
    got = model.predict(split_columns(x[500:], 3))
    want = jmodel.predict(split_columns(x[500:], 3))
    if task == "classification":
        assert got.dtype == np.int32
        near = np.abs(jz) < RTOL * np.abs(jz).max() + ATOL
        assert int(near.sum()) == 0            # none on this fixture
        np.testing.assert_array_equal(got[~near], want[~near])
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_partition_and_legacy_blocks_agree():
    """Twin of tests/test_federation.py: the session's partition path and
    the legacy block-list path train the same F-LR model."""
    x, y = make_classification(400, 12, 2, seed=7)
    fed = Federation(parties=2, device="cpu")
    part = fed.ingest(x[:300], y[:300])
    m_sess = fed.fit(LinearParams(steps=150))
    assert isinstance(m_sess, FederatedLinear)
    m_legacy = FederatedLinear(steps=150, device="cpu").fit(
        part.split_raw(x[:300]), y[:300])
    np.testing.assert_array_equal(fed.predict(m_sess, x[300:]),
                                  m_legacy.predict(part.split_raw(x[300:])))
    with pytest.raises(ValueError, match="needs a partition"):
        FederatedLinear(device="cpu").fit(x[:10], y[:10])


def test_fedlinear_classification_parity():
    """F-LR with M parties == single-party logistic regression (the party
    sum of the block products IS the full product)."""
    x, y = make_classification(600, 20, 2, seed=4)
    f1 = FederatedLinear(device="cpu").fit([x[:500]], y[:500])
    f3 = FederatedLinear(device="cpu").fit(split_columns(x[:500], 3), y[:500])
    p1 = f1.predict([x[500:]])
    p3 = f3.predict(split_columns(x[500:], 3))
    assert np.mean(p1 == p3) > 0.99
    assert accuracy(y[500:], p3) > 0.7


def test_fedlinear_regression():
    x, y = make_regression(600, 15, nonlinear=False, noise=0.1, seed=5)
    fl = FederatedLinear(task="regression", lr=0.3, steps=600,
                         device="cpu").fit(split_columns(x[:500], 2), y[:500])
    pred = fl.predict(split_columns(x[500:], 2))
    assert rmse(y[500:], pred) < 0.5 * np.std(y[500:])


def test_pairwise_masks_cancel():
    m = crypto.pairwise_cancelling_masks(5, (3, 2), seed=3)
    np.testing.assert_allclose(m.sum(0), 0.0, atol=1e-5)
    np.testing.assert_array_equal(
        m, jcrypto.pairwise_cancelling_masks(5, (3, 2), seed=3))
    names = [f"f{i}" for i in range(7)]
    assert crypto.encode_feature_names(names, 2) == \
        jcrypto.encode_feature_names(names, 2)


def test_ztest_sanity():
    rng = np.random.default_rng(0)
    a = rng.normal(0, 1, 200)
    _, p_same = ztest_two_sample(a, a + rng.normal(0, 0.01, 200))
    _, p_diff = ztest_two_sample(a, a + 1.0)
    assert p_same > 0.05 and p_diff < 0.01
    assert ztest_two_sample(a, a) == (0.0, 1.0)


def test_f1_binary():
    assert f1_binary([1, 1, 0, 0], [1, 0, 0, 0]) == pytest.approx(2 / 3)
    assert f1_binary([0, 0], [0, 0]) == 0.0


def test_datasets_equal_jax():
    assert {k: tuple(vars(v).values()) for k, v in DATASETS.items()} == \
        {k: tuple(vars(v).values()) for k, v in jtabular.DATASETS.items()}
    for name in ("ionosphere", "superconduct"):
        x, y, spec = load_dataset(name, seed=3)
        jx, jy, _ = jtabular.load_dataset(name, seed=3)
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
        assert x.shape == (spec.n, spec.f)
