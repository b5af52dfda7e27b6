"""One-round prediction of the PyTorch port (on the CPU) against the JAX
package, on the same forests carried across by repro_torch.convert in both
directions.  Each sample meets exactly one leaf and every other mask column
adds an exact zero, so classification votes are equal bit for bit, and so
is every variant: dense or leaf-compacted mask, einsum or argmax vote,
int32 or uint8 party sum."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import prediction as jpred
from repro.core.forest import FederatedForest as JForest
from repro.core.party import make_vertical_partition as j_make_partition
from repro.core.tree import PartyTree as JPartyTree
from repro.core.types import ForestParams as JParams
from repro.federation import programs as jprograms
from repro.federation.substrate import SimulatedSubstrate as JSimulated
from repro.serving import plan as jplan
from repro_torch import convert
from repro_torch.core import prediction
from repro_torch.core.forest import FederatedForest
from repro_torch.core.types import ForestParams
from repro_torch.data import make_classification, make_regression
from repro_torch.serving import plan

CPU = torch.device("cpu")
KW = {"classification": dict(n_estimators=4, max_depth=5, n_bins=16, seed=3),
      "regression": dict(task="regression", n_estimators=4, max_depth=5,
                         n_bins=16, seed=3)}


@functools.lru_cache(maxsize=None)
def _setup(task):
    """(JAX params, port params, JAX fit, port fit, binned test rows)."""
    if task == "classification":
        x, y = make_classification(1000, 13, 2, n_informative=5, seed=1)
    else:
        x, y = make_regression(1000, 13, seed=2)
    jpart = j_make_partition(x[:800], 2, 16)
    jp, p = JParams(**KW[task]), ForestParams(**KW[task])
    jmodel = JForest(jp).fit(jpart, y[:800])
    part = convert.partition_from_numpy(jpart.xb, jpart.feat_gid,
                                        jpart.n_features, jpart.boundaries)
    model = FederatedForest(p, device="cpu").fit(part, y[:800])
    return jp, p, jmodel, model, jpart.bin_test(x[800:])


def _jax_predict(jp, trees_np, xbt, *, compact=False, mask_dtype=jnp.int32,
                 vote_impl="einsum"):
    trees = JPartyTree(**{k: jnp.asarray(v) for k, v in trees_np.items()})
    fn = jax.jit(jprograms.forest_predict_program(
        JSimulated(), jp, compact=compact, mask_dtype=mask_dtype,
        vote_impl=vote_impl))
    shared = (jplan.build_leaf_table(trees, jp).leaf_idx,) if compact else ()
    return jprograms.party0(fn(trees, jnp.asarray(xbt), *shared))


def _port_predict(p, trees_np, xbt, *, compact=False, mask_dtype=torch.int32,
                  vote_impl="einsum"):
    trees = convert.party_trees_from_numpy(trees_np, CPU)
    leaf_idx = plan.build_leaf_table(trees, p).leaf_idx if compact else None
    out = prediction.forest_predict_oneround(
        trees, torch.as_tensor(xbt), p, mask_dtype=mask_dtype,
        vote_impl=vote_impl, leaf_idx=leaf_idx)
    return out.numpy()


def _jax_trees(jmodel):
    return {f: np.asarray(getattr(jmodel.trees_, f))
            for f in JPartyTree._fields}


PORT_VARIANTS = [dict(compact=c, mask_dtype=d, vote_impl=v)
                 for c in (False, True) for d in (torch.int32, torch.uint8)
                 for v in ("einsum", "argmax")]


@pytest.mark.parametrize("kw", PORT_VARIANTS,
                         ids=lambda kw: "-".join(str(v).replace("torch.", "")
                                                 for v in kw.values()))
def test_port_predicts_jax_forest(kw):
    jp, p, jmodel, _, xbt = _setup("classification")
    trees = _jax_trees(jmodel)
    want = _jax_predict(jp, trees, xbt)
    np.testing.assert_array_equal(_port_predict(p, trees, xbt, **kw), want)


@pytest.mark.parametrize("kw", [dict(),
                                dict(compact=True, mask_dtype=jnp.uint8),
                                dict(compact=True, vote_impl="argmax")])
def test_jax_predicts_port_forest(kw):
    jp, p, _, model, xbt = _setup("classification")
    trees = convert.party_trees_to_numpy(model.trees_)
    want = _port_predict(p, trees, xbt)
    np.testing.assert_array_equal(_jax_predict(jp, trees, xbt, **kw), want)


@pytest.mark.parametrize("compact", [False, True])
def test_regression_predictions_across_packages(compact):
    """Per-tree values are exact (one leaf each); the forest mean over
    trees may associate differently, so it agrees to float32 rounding."""
    jp, p, jmodel, model, xbt = _setup("regression")
    for trees in (_jax_trees(jmodel), convert.party_trees_to_numpy(model.trees_)):
        got = _port_predict(p, trees, xbt, compact=compact)
        want = _jax_predict(jp, trees, xbt, compact=compact)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_estimator_dense_equals_compact_and_decodes():
    _, _, jmodel, model, _ = _setup("classification")
    x, y = make_classification(1000, 13, 2, n_informative=5, seed=1)
    dense, compact = model.predict(x[800:]), model.predict_compact(x[800:])
    np.testing.assert_array_equal(dense, compact)
    np.testing.assert_array_equal(dense, jmodel.predict(x[800:]))
    assert np.mean(dense == y[800:]) > 0.7


def test_leaf_table_and_accounting_equal_jax():
    jp, p, jmodel, model, _ = _setup("classification")
    got = plan.build_leaf_table(model.trees_, p)
    want = jplan.build_leaf_table(jmodel.trees_, jp)
    np.testing.assert_array_equal(got.leaf_idx.numpy(), np.asarray(want.leaf_idx))
    np.testing.assert_array_equal(got.n_live.numpy(), np.asarray(want.n_live))
    assert got.capacity == want.capacity
    assert plan.compaction_ratio(got, p) == jplan.compaction_ratio(want, jp)
    for mt, jt in ((torch.int32, jnp.int32), (torch.uint8, jnp.uint8)):
        assert prediction.mask_comm_bytes(4, 100, 63, mt) == \
            jpred.mask_comm_bytes(4, 100, 63, jt)
    for method in ("oneround", "classical"):
        assert prediction.comm_rounds(p, method) == jpred.comm_rounds(jp, method)
    with pytest.raises(ValueError):
        prediction.comm_rounds(p, "gossip")
