"""A PyTorch twin of examples/quickstart.py at N = 2000, on the CPU: two
organizations (11 + 84 features) align hashed IDs, ingest, fit and predict
through the port's ``Federation``; the forest equals the JAX session's bit
for bit and the paper's losslessness assert holds.  Plus the session's
contract: it runs on the card unless told otherwise, and never falls back
to the CPU silently."""
import functools

import numpy as np
import pytest
import torch

from repro.core.types import ForestParams as JParams
from repro.federation import Federation as JFederation
from repro_torch import convert
from repro_torch.core import crypto
from repro_torch.core.forest import FederatedForest
from repro_torch.core.types import ForestParams
from repro_torch.data import accuracy, make_classification, train_test_split
from repro_torch.federation import Federation

KW = dict(task="classification", n_estimators=5, max_depth=6, n_bins=32,
          seed=42)


@functools.lru_cache(maxsize=None)
def _data():
    x, y = make_classification(2000, 95, 2, n_informative=24, seed=0)
    return train_test_split(x, y, 0.25, seed=1)


def _session(parties, xtr, ytr, **kw):
    fed = Federation(parties=parties, n_bins=32, device="cpu", **kw)
    fed.ingest(xtr, ytr)
    return fed, fed.fit(ForestParams(**KW))


def test_quickstart_twin_lossless_and_equal_to_jax():
    xtr, ytr, xte, yte = _data()
    ids = np.arange(len(xtr))
    ia, ib = crypto.align_ids(crypto.hash_ids(ids, salt="2026-07"),
                              crypto.hash_ids(ids, salt="2026-07"))
    assert len(ia) == len(ib) == len(xtr)

    fed, model = _session(2, xtr, ytr)
    pred = fed.predict(model, xte)
    assert accuracy(yte, pred) > 0.75

    for cols in (np.arange(0, 11), np.arange(11, 95)):     # each party alone
        solo_fed, solo = _session(1, xtr[:, cols], ytr)
        assert accuracy(yte, solo_fed.predict(solo, xte[:, cols])) > 0.6

    central_fed, central = _session(1, xtr, ytr)
    same = np.array_equal(central_fed.predict(central, xte), pred)
    assert same, "losslessness violated"

    jfed = JFederation(parties=2, n_bins=32)
    jfed.ingest(xtr, ytr)
    jmodel = jfed.fit(JParams(**KW))
    got = convert.party_trees_to_numpy(model.trees_)
    for f, a in got.items():
        np.testing.assert_array_equal(a, np.asarray(getattr(jmodel.trees_, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(pred, jfed.predict(jmodel, xte))


def test_default_device_is_the_card():
    """No device means the CUDA card: on a host without one, the session
    and the estimator raise instead of running on the CPU."""
    if torch.cuda.is_available():
        assert Federation(parties=2).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Federation(parties=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FederatedForest(ForestParams())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Federation(parties=2, device="cuda")


def test_session_contract():
    xtr, ytr, xte, _ = _data()
    fed = Federation(parties=2, n_bins=32, device="cpu")
    with pytest.raises(ValueError, match="no training data"):
        fed.fit(ForestParams(**KW))
    fed.ingest(xtr[:300, :20], ytr[:300])
    with pytest.raises(ValueError, match="n_bins"):
        fed.fit(ForestParams(**{**KW, "n_bins": 16}))
    with pytest.raises(TypeError, match="ForestParams"):
        fed.fit(object())
    with pytest.raises(ValueError, match="unknown substrate"):
        Federation(substrate="sharded", device="cpu")

    small = dict(KW, n_estimators=2, max_depth=3)
    model = fed.fit(ForestParams(**small))
    plan = fed._plan_for(model)
    fed.predict(model, xte[:, :20])
    assert fed._plan_for(model) is plan            # cached per model
    model.trees_ = fed.fit(ForestParams(**small)).trees_
    assert fed._plan_for(model) is not plan        # rebuilt after a refit


def test_session_hist_impl_override():
    xtr, ytr, _, _ = _data()
    small = ForestParams(**dict(KW, n_estimators=2, max_depth=3))
    trees = {}
    for impl in ("scatter", "ref", "cuda"):
        fed = Federation(parties=2, n_bins=32, device="cpu", hist_impl=impl)
        fed.ingest(xtr[:400, :30], ytr[:400])
        model = fed.fit(small)
        assert model.params.hist_impl == impl
        trees[impl] = convert.party_trees_to_numpy(model.trees_)
    for f, a in trees["scatter"].items():
        np.testing.assert_array_equal(trees["ref"][f], a)
        np.testing.assert_array_equal(trees["cuda"][f], a)
    fed = Federation(parties=2, n_bins=32, device="cpu", hist_impl="pallas")
    fed.ingest(xtr[:100, :10], ytr[:100])
    with pytest.raises(ValueError, match="unknown impl"):
        fed.fit(small)
