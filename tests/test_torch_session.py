"""A PyTorch twin of examples/quickstart.py at N = 2000, on the CPU: two
organizations (11 + 84 features) align hashed IDs, ingest, fit and predict
through the port's ``Federation``; the forest equals the JAX session's bit
for bit and the paper's losslessness assert holds.  Plus the session's
contract: it runs on the card unless told otherwise, and never falls back
to the CPU silently; it fits, predicts, saves and loads every model family
(forest, boosting, F-LR), and boosting checkpoints cross packages."""
import functools
import pathlib

import numpy as np
import pytest
import torch

from repro.core.boosting import BoostParams as JBoostParams
from repro.core.types import ForestParams as JParams
from repro.federation import Federation as JFederation
from repro_torch import convert
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.core import (BoostParams, FederatedBoosting, FederatedLinear,
                              LinearParams, crypto, make_vertical_partition,
                              split_columns)
from repro_torch.core.forest import FederatedForest
from repro_torch.core.types import ForestParams
from repro_torch.data import (accuracy, make_classification, make_regression,
                              train_test_split)
from repro_torch.federation import Estimator, Federation

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
        Federation(substrate="carrier-pigeon", device="cpu")
    with pytest.raises(ValueError, match="requires a mesh"):
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


# ------------------------------------------------ boosting and F-LR specs
def _reg_session(parties=2):
    x, y = make_regression(400, 10, seed=6)
    fed = Federation(parties=parties, n_bins=16, device="cpu")
    fed.ingest(x[:300], y[:300])
    return fed, x[300:]


def test_fit_dispatches_on_all_three_specs():
    xtr, ytr, xte, _ = _data()
    fed = Federation(parties=2, n_bins=16, device="cpu")
    fed.ingest(xtr[:400, :30], ytr[:400])
    models = {
        FederatedForest: fed.fit(ForestParams(**dict(KW, n_estimators=2,
                                                     max_depth=3, n_bins=16))),
        FederatedBoosting: fed.fit(BoostParams(task="binary", n_rounds=3,
                                               max_depth=3, n_bins=16)),
        FederatedLinear: fed.fit(LinearParams(steps=50)),
    }
    for cls, model in models.items():
        assert type(model) is cls and isinstance(model, Estimator)
        assert model.device.type == "cpu"
        pred = fed.predict(model, xte[:, :30])
        assert pred.shape == (len(xte),) and set(np.unique(pred)) <= {0, 1}
    with pytest.raises(ValueError, match="n_bins"):
        fed.fit(BoostParams(n_bins=32))
    session = Federation(parties=2, n_bins=16, device="cpu",
                         hist_impl="ref")
    session.ingest(xtr[:200, :10], ytr[:200])
    assert session.fit(BoostParams(task="binary", n_rounds=1, n_bins=16)) \
        .params.hist_impl == "ref"
    assert isinstance(session.fit(LinearParams(steps=5)), FederatedLinear)


def test_boosting_save_load_and_family_refusals(tmp_path):
    """Twin of tests/test_federation.py's family-tag test: a boosting
    stack never reloads as a forest, nor under another task or learning
    rate; it reloads as boosting with its base and rounds."""
    fed, xte = _reg_session()
    bp = BoostParams(n_rounds=3, max_depth=3, n_bins=16)
    model = fed.fit(bp)
    d = str(tmp_path / "boost")
    fed.save(model, d)
    assert ckpt.read_meta(d, 3) == {
        "family": "boosting", "task": "regression", "n_rounds": 3,
        "learning_rate": 0.2, "base": model.base_}
    with pytest.raises(ValueError, match="boosting"):
        fed.load(d, ForestParams(task="regression", n_estimators=3,
                                 n_bins=16))
    with pytest.raises(ValueError, match="task"):
        fed.load(d, BoostParams(task="binary", n_rounds=3, max_depth=3,
                                n_bins=16))
    with pytest.raises(ValueError, match="learning_rate"):
        fed.load(d, BoostParams(n_rounds=3, max_depth=3, n_bins=16,
                                learning_rate=0.3))
    restored = fed.load(d, bp)
    assert isinstance(restored, FederatedBoosting)
    assert restored.base_ == model.base_
    assert len(restored.trees_) == len(model.trees_)
    np.testing.assert_array_equal(restored.predict(xte), model.predict(xte))
    np.testing.assert_array_equal(fed.predict(restored, xte),
                                  fed.predict(model, xte))
    # the reverse mismatch: a forest checkpoint refuses BoostParams
    fmodel = fed.fit(ForestParams(task="regression", n_estimators=2,
                                  max_depth=3, n_bins=16))
    d2 = str(tmp_path / "forest")
    fed.save(fmodel, d2)
    with pytest.raises(ValueError, match="forest"):
        fed.load(d2, BoostParams(n_rounds=2, n_bins=16))
    with pytest.raises(TypeError, match="fitted model"):
        fed.save(FederatedBoosting(bp, device="cpu"), d2)
    with pytest.raises(ValueError, match="partition has 3"):
        fed.load(d, bp, partition=_reg_session(3)[0]._partition)


@pytest.mark.parametrize("task", ["regression", "binary"])
def test_boosting_checkpoints_cross_packages(task, tmp_path):
    """A JAX-saved boosting checkpoint loads in the port and predicts as
    JAX does; the port saves the same stack to the same bytes."""
    x, y = make_regression(400, 10, seed=6)
    if task == "binary":
        y = (y > np.median(y)).astype(np.int64)
    kw = dict(task=task, n_rounds=3, max_depth=3, n_bins=16)
    jfed = JFederation(parties=2, n_bins=16)
    jfed.ingest(x[:300], y[:300])
    jmodel = jfed.fit(JBoostParams(**kw))
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jfed.save(jmodel, jdir)
    fed = Federation(parties=2, n_bins=16, device="cpu")
    fed.ingest(x[:300], y[:300])
    model = fed.load(jdir, BoostParams(**kw))
    assert model.base_ == jmodel.base_
    np.testing.assert_allclose(model.decision_function(x[300:]),
                               jmodel.decision_function(x[300:]),
                               rtol=1e-5, atol=1e-6)
    if task == "binary":
        np.testing.assert_array_equal(fed.predict(model, x[300:]),
                                      jfed.predict(jmodel, x[300:]))
    fed.save(model, pdir)
    for name in ("arrays.msgpack.zst", "arrays.msgpack.zlib",
                 "meta.msgpack"):
        a, b = (pathlib.Path(d) / "step_00000003" / name
                for d in (pdir, jdir))
        assert a.exists() == b.exists()
        if a.exists():
            assert a.read_bytes() == b.read_bytes(), name


def test_all_three_federated_models_on_shared_partition():
    """Twin of tests/test_boosting_vs_forest.py: forest, boosting and F-LR
    on the same vertical data, and the F-LR ordering of the paper's
    Table 1."""
    x, y = make_classification(800, 24, 2, n_informative=8, seed=21)
    xtr, ytr, xte, yte = x[:600], y[:600], x[600:], y[600:]
    part = make_vertical_partition(xtr, 3, 32)
    ff = FederatedForest(ForestParams(n_estimators=10, max_depth=6,
                                      n_bins=32, seed=4),
                         device="cpu").fit(part, ytr)
    fb = FederatedBoosting(BoostParams(task="binary", n_rounds=20,
                                       max_depth=3),
                           device="cpu").fit(part, ytr)
    fl = FederatedLinear(device="cpu").fit(split_columns(xtr, 3), ytr)
    accs = {
        "forest": accuracy(yte, ff.predict(xte)),
        "boosting": accuracy(yte, fb.predict(xte)),
        "linear": accuracy(yte, fl.predict(split_columns(xte, 3))),
    }
    for name, a in accs.items():
        assert a > 0.75, (name, a)
    assert max(accs["forest"], accs["boosting"]) >= accs["linear"] - 0.05
