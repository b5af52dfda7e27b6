"""The port's federated gradient boosting against the JAX package's, on the
CPU.

Boosting trains one regression tree a round on float stats whose middle
channel is signed and cancels, and the rounds chain.  So the bar is per
round: started from the SAME margin ``f_cur`` (the JAX fit's), each round
of the port has JAX's splits, with leaf stats within rtol 1e-5 of the
node's Σ|stat|; and over all rounds, ``decision_function`` within rtol 1e-5
(atol 1e-6) with equal binary predictions.  Near-ties in gain break
differently in XLA and in the port (ROADMAP Queue 3, *Contracts*), so the
fixtures are seeds whose rounds meet none: ``make_regression(600, 12,
seed=0)`` and ``make_classification(600, 12, 2, seed=1)``, 2 parties,
450 training rows, depth 4, 16 bins, 8 rounds.  Inside the port, FB(2) ==
FB(1) bit for bit, as the paper's losslessness asks of the forest.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.boosting import BoostParams as JBoostParams
from repro.core.boosting import FederatedBoosting as JBoosting
from repro.core.party import make_vertical_partition as j_make_partition
from repro.federation import programs as jprograms
from repro_torch import convert
from repro_torch.core import (BoostParams, FederatedBoosting,
                              make_vertical_partition, split_rounds,
                              stack_rounds)
from repro_torch.data import (accuracy, make_classification, make_regression,
                              rmse)
from repro_torch.federation import programs
from repro_torch.federation.substrate import SimulatedSubstrate

SPLIT_FIELDS = ("is_leaf", "has_split", "split_floc", "split_bin", "owner",
                "split_gid")
TASKS = ("regression", "binary")
KW = dict(n_rounds=8, max_depth=4, n_bins=16)


@functools.lru_cache(maxsize=None)
def _data(task):
    if task == "regression":
        return make_regression(600, 12, seed=0)
    return make_classification(600, 12, 2, seed=1)


@functools.lru_cache(maxsize=None)
def _jax_fit(task):
    x, y = _data(task)
    jpart = j_make_partition(x[:450], 2, 16)
    return jpart, JBoosting(JBoostParams(task=task, **KW)).fit(jpart, y[:450])


def _port_fit(task, parties=2, **kw):
    x, y = _data(task)
    part = make_vertical_partition(x[:450], parties, 16)
    return FederatedBoosting(BoostParams(task=task, **dict(KW, **kw)),
                             device="cpu").fit(part, y[:450])


def _jax_rounds(jmodel):
    return [{f: np.asarray(getattr(t, f)) for f in SPLIT_FIELDS
             + ("leaf_stats",)} for t in jmodel.trees_]


def _leaf_stats_close(got, want):
    """Each channel within 1e-5 of the node's Σ|stat|: channels 0 (Σhh)
    and 2 (Σhh·p²) are positive sums, and Σ|hh·p| <= (c0 + c2) / 2, so
    c0 + c2 bounds every channel's Σ|stat|."""
    scale = want[..., 0] + want[..., 2]
    err = np.abs(got - want).max(-1)
    assert (err <= 1e-5 * scale + 1e-30).all(), float((err - 1e-5 * scale).max())


@pytest.mark.parametrize("task", TASKS)
def test_rounds_from_shared_f_cur_same_splits_as_jax(task):
    x, y = _data(task)
    jpart, jmodel = _jax_fit(task)
    model = FederatedBoosting(BoostParams(task=task, **KW), device="cpu")
    part = convert.partition_from_numpy(jpart.xb, jpart.feat_gid,
                                        jpart.n_features, jpart.boundaries)
    prog = model._round_program(part)
    yy = np.asarray(y[:450], np.float64)
    f = np.full(450, jmodel.base_)
    xb = jnp.asarray(jpart.xb)
    for r, want in enumerate(_jax_rounds(jmodel)):
        got = convert.party_trees_to_numpy(model._fit_round(prog, yy, f))
        for k in SPLIT_FIELDS:
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"round {r} {k}")
        _leaf_stats_close(got["leaf_stats"], want["leaf_stats"])
        # the next round starts from JAX's margin
        f = f + jmodel.params.learning_rate * jprograms.party0(
            jmodel._pred_run(jmodel.trees_[r], xb))


@pytest.mark.parametrize("task", TASKS)
def test_decision_function_within_tolerance_of_jax(task):
    x, _ = _data(task)
    _, jmodel = _jax_fit(task)
    model = _port_fit(task)
    assert model.base_ == jmodel.base_
    got, want = model.decision_function(x[450:]), jmodel.decision_function(
        x[450:])
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(model.predict(x[450:]),
                                  jmodel.predict(x[450:]))
    # JAX's rounds, converted, predict in the port as they do in JAX
    model.trees_ = convert.boosting_rounds_from_numpy(jmodel.trees_, "cpu")
    np.testing.assert_allclose(model.decision_function(x[450:]), want,
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("task", TASKS)
def test_fb2_equals_fb1_bit_for_bit(task):
    x, _ = _data(task)
    one, two = _port_fit(task, parties=1), _port_fit(task, parties=2)
    for a, b in zip(one.trees_, two.trees_):
        ta, tb = (convert.party_trees_to_numpy(t) for t in (a, b))
        for k in ("is_leaf", "leaf_stats", "split_gid"):
            np.testing.assert_array_equal(ta[k][0], tb[k][0], err_msg=k)
    np.testing.assert_array_equal(one.decision_function(x[450:]),
                                  two.decision_function(x[450:]))


@pytest.mark.parametrize("task", TASKS)
def test_one_wave_program_equals_decision_function(task):
    """programs.boosting_predict_program: every round in one party sum,
    base + lr·Σ rounds in float32, thresholded for the binary task."""
    x, _ = _data(task)
    model = _port_fit(task)
    xbt = torch.as_tensor(model._partition.bin_test(x[450:]))
    base = torch.tensor(model.base_, dtype=torch.float32)
    for compact in (False, True):
        run = programs.boosting_predict_program(SimulatedSubstrate(),
                                                model.params, compact=compact)
        stack = stack_rounds(model.trees_)
        shared = ()
        if compact:
            from repro_torch.serving import plan
            shared = (plan.build_leaf_table(
                stack, model.params.tree_params()).leaf_idx,)
        out = programs.party0(run(stack, xbt, base, *shared))
        if task == "binary":
            np.testing.assert_array_equal(out, model.predict(x[450:]))
        else:
            np.testing.assert_allclose(out, model.decision_function(x[450:]),
                                       rtol=1e-5, atol=1e-5)


def test_stack_split_round_trip():
    model = _port_fit("regression", n_rounds=3)
    stack = stack_rounds(model.trees_)
    assert stack.is_leaf.shape[:2] == (2, 3)
    back = split_rounds(stack)
    assert len(back) == 3
    for a, b in zip(back, model.trees_):
        for fa, fb in zip(a, b):
            assert torch.equal(fa, fb)
    assert stack_rounds(model.trees_[:1]) is model.trees_[0]
    with pytest.raises(ValueError, match="no fitted rounds"):
        stack_rounds([])


# torch twins of tests/test_extensions.py's boosting tests (same data and
# params as there)
def test_boosting_regression_beats_mean():
    x, y = make_regression(600, 16, seed=1)
    part = make_vertical_partition(x[:450], 3, 32)
    fb = FederatedBoosting(BoostParams(task="regression", n_rounds=25,
                                       max_depth=4),
                           device="cpu").fit(part, y[:450])
    pred = fb.predict(x[450:])
    base = rmse(y[450:], np.full(150, y[:450].mean()))
    assert rmse(y[450:], pred) < 0.6 * base


def test_boosting_binary_classification():
    x, y = make_classification(700, 20, 2, seed=2)
    part = make_vertical_partition(x[:500], 4, 32)
    fb = FederatedBoosting(BoostParams(task="binary", n_rounds=25,
                                       max_depth=3),
                           device="cpu").fit(part, y[:500])
    assert accuracy(y[500:], fb.predict(x[500:])) > 0.8


def test_boosting_training_loss_monotone():
    """Each boosting round must not increase training loss (learning-rate
    damped Newton steps on a convex objective)."""
    x, y = make_regression(300, 10, seed=3)
    part = make_vertical_partition(x, 2, 16)
    fb = FederatedBoosting(BoostParams(task="regression", n_rounds=10,
                                       learning_rate=0.3),
                           device="cpu").fit(part, y)
    losses = []
    f = np.full(len(y), fb.base_)
    xb = torch.as_tensor(part.xb)
    for trees in fb.trees_:
        f = f + fb.params.learning_rate * programs.party0(
            fb._pred_run(trees, xb))
        losses.append(float(np.mean((f - y) ** 2)))
    assert all(b <= a + 1e-6 for a, b in zip(losses, losses[1:])), losses
