"""Checkpoints, ``fit_resumable`` and ``save`` / ``load`` in the PyTorch
port, held against the JAX package on the CPU.

The port's MessagePack codec writes ``msgpack.packb``'s bytes; both
packages write byte-identical checkpoint files for the same trees, agree on
the resumable-fit fingerprint, and restore each other's checkpoints — a
forest saved by one predicts the other's predictions, and a JAX
``fit_resumable`` checkpoint resumed by the port equals JAX's from-scratch
forest.  Inside the port: extending, slicing ahead, resuming after a lost
chunk, restarting on a new fingerprint, and ``load``'s family checks."""
import os
import pathlib
import shutil
from typing import NamedTuple

import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt
from repro.core.partyblock import PartyBlock as JBlock
from repro.core.tree import PartyTree as JPartyTree
from repro.core.types import ForestParams as JParams
from repro.federation import Federation as JFederation
from repro_torch import convert
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.ckpt import msgpack as codec
from repro_torch.core import tree as tree_mod
from repro_torch.core.types import ForestParams
from repro_torch.data import (make_classification, make_party_views,
                              make_regression)
from repro_torch.federation import Federation
from repro_torch.serving.engine import load_forest_trees
from repro_torch.streaming import ArraySource

KW = dict(n_estimators=4, max_depth=4, n_bins=16, seed=3)


def _data(task="classification", n=400):
    if task == "classification":
        return make_classification(n, 8, 2, seed=1)
    return make_regression(n, 8, seed=1)


def _fed(x, y, parties=2):
    fed = Federation(parties=parties, n_bins=16, device="cpu")
    fed.ingest(x, y)
    return fed


def _jfed(x, y, parties=2):
    fed = JFederation(parties=parties, n_bins=16)
    fed.ingest(x, y)
    return fed


def _np_trees(trees):
    if isinstance(trees, JPartyTree):
        return {f: np.asarray(getattr(trees, f)) for f in JPartyTree._fields}
    return convert.party_trees_to_numpy(trees)


def _trees_equal(a, b):
    ta, tb = _np_trees(a), _np_trees(b)
    for f in ta:
        np.testing.assert_array_equal(ta[f], tb[f], err_msg=f)


def _step_files(d, step):
    p = pathlib.Path(d) / f"step_{step:08d}"
    return {f.name: f.read_bytes() for f in sorted(p.iterdir())}


@pytest.fixture
def built(monkeypatch):
    """Counts the trees the port builds (one build_tree call per tree)."""
    count = {"trees": 0}
    real = tree_mod.build_tree

    def counting(*a, **k):
        count["trees"] += 1
        return real(*a, **k)
    monkeypatch.setattr(tree_mod, "build_tree", counting)
    return count


# ------------------------------------------------------------------- codec
def _payload(trees):
    return {k: {"dtype": str(v.dtype), "shape": list(v.shape),
                "data": v.tobytes()} for k, v in ckpt._flatten(trees).items()}


def _forest_payload():
    return _payload(_fed(*_data()).fit(ForestParams(**KW)).trees_)


@pytest.mark.parametrize("obj", [
    _forest_payload,
    {"family": "forest", "fingerprint": "ab" * 32},
    {"family": "boosting", "task": "regression", "n_rounds": 7,
     "learning_rate": 0.1, "base": -3.25},
    {"ints": [0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
              2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2**31,
              -2**31 - 1, -2**63],
     "floats": [0.0, -0.0, 1.5, 1e300, float("inf")],
     "flags": [True, False, None], "nested": {"t": (1, "x"), "e": []}},
    {"s" * n: "é" * n for n in (1, 31, 32, 255, 256, 70000)},
    {"bins": [b"", b"x" * 255, b"x" * 256, b"x" * 70000],
     "arrays": [list(range(n)) for n in (15, 16, 70000)]},
    {str(i): i for i in (15, 16, 70000) for i in range(i)},
])
def test_codec_bytes_equal_msgpack(obj):
    msgpack = pytest.importorskip("msgpack")
    obj = obj() if callable(obj) else obj
    packed = codec.packb(obj)
    assert packed == msgpack.packb(obj, use_bin_type=True)
    back = codec.unpackb(packed)
    assert back == msgpack.unpackb(packed, raw=False)
    assert codec.packb(back) == packed


@pytest.mark.parametrize("data,err,match", [
    (b"\x92\x01", ValueError, "truncated"),
    (b"\x01\x02", ValueError, "after its object"),
    (b"\xc1", ValueError, "unsupported"),
    (b"\x81\x01\x02", ValueError, "not a str"),
])
def test_codec_rejects_malformed(data, err, match):
    with pytest.raises(err, match=match):
        codec.unpackb(data)


@pytest.mark.parametrize("obj,err", [(2**64, OverflowError),
                                     (-2**63 - 1, OverflowError),
                                     ({1, 2}, TypeError),
                                     (np.int64(3), TypeError)])
def test_codec_rejects_what_msgpack_rejects(obj, err):
    msgpack = pytest.importorskip("msgpack")
    with pytest.raises(err):
        codec.packb(obj)
    with pytest.raises(err):
        msgpack.packb(obj, use_bin_type=True)


# ------------------------------------------------------ format and keys
class _Pair(NamedTuple):
    left: np.ndarray
    right: np.ndarray


def test_flatten_keys_equal_jax_and_restore(tmp_path):
    tree = {"b": [np.zeros(1), (np.ones(2), None)],
            "a": {"z": np.int32(3), "c": np.arange(4.0)},
            "p": _Pair(np.arange(3, dtype=np.int16), np.ones((2, 2), bool))}
    got, want = ckpt._flatten(tree), jckpt._flatten(tree)
    assert list(got) == list(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype
    ckpt.save_checkpoint(tmp_path, 3, tree, meta={"k": 1})
    jckpt.save_checkpoint(tmp_path / "jax", 3, tree, meta={"k": 1})
    assert _step_files(tmp_path, 3) == _step_files(tmp_path / "jax", 3)
    like = {"a": {"z": torch.zeros(0, dtype=torch.int64),
                  "c": np.zeros(0, np.float32)},
            "b": [torch.zeros(0), (np.zeros(0), None)],
            "p": _Pair(np.zeros(0, np.int16),
                       torch.zeros(0, dtype=torch.bool))}
    back = ckpt.restore_checkpoint(tmp_path, 3, like)
    assert back["a"]["z"].dtype == torch.int64 and int(back["a"]["z"]) == 3
    assert back["a"]["c"].dtype == np.float32
    np.testing.assert_array_equal(back["p"].left, np.arange(3))
    assert back["p"].right.dtype == torch.bool and bool(back["p"].right.all())
    assert back["b"][1][1] is None
    assert ckpt.read_meta(tmp_path, 3) == {"k": 1}
    assert ckpt.latest_step(tmp_path) == 3
    with pytest.raises(KeyError):
        ckpt.restore_checkpoint(tmp_path, 3, {"missing": np.zeros(1)})


def test_zlib_without_zstandard_and_zst_needs_it(tmp_path, monkeypatch):
    ckpt.save_checkpoint(tmp_path / "zst", 1, {"a": np.arange(3)})
    monkeypatch.setattr(ckpt, "zstandard", None)
    ckpt.save_checkpoint(tmp_path / "zl", 1, {"a": np.arange(3)})
    assert list(_step_files(tmp_path / "zl", 1)) == ["arrays.msgpack.zlib"]
    np.testing.assert_array_equal(
        ckpt.peek_checkpoint(tmp_path / "zl", 1)["a"], np.arange(3))
    # the JAX package reads the port's zlib checkpoint
    np.testing.assert_array_equal(
        jckpt.peek_checkpoint(tmp_path / "zl", 1)["a"], np.arange(3))
    if (tmp_path / "zst" / "step_00000001" / "arrays.msgpack.zst").exists():
        with pytest.raises(ModuleNotFoundError, match="zstandard"):
            ckpt.peek_checkpoint(tmp_path / "zst", 1)


# ------------------------------------------------- across the two packages
@pytest.mark.parametrize("task", ["classification", "regression"])
def test_forest_checkpoints_cross_packages(task, tmp_path):
    """Byte-identical files for the same trees; a JAX checkpoint loads in
    the port and predicts JAX's predictions, and the reverse."""
    x, y = _data(task)
    p = dict(KW, task=task)
    jfed = _jfed(x, y)
    jmodel = jfed.fit(JParams(**p))
    fed = _fed(x, y)
    trees = convert.party_trees_from_numpy(jmodel.trees_, "cpu")
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jfed.save(jmodel, jdir)
    model = fed.load(jdir, ForestParams(**p))
    assert model.trees_.is_leaf.device.type == "cpu"
    _trees_equal(model.trees_, jmodel.trees_)
    np.testing.assert_array_equal(fed.predict(model, x[:80]),
                                  jfed.predict(jmodel, x[:80]))
    fed.save(model, pdir)
    assert _step_files(pdir, 4) == _step_files(jdir, 4)
    jback = jfed.load(pdir, JParams(**p))
    np.testing.assert_array_equal(jfed.predict(jback, x[:80]),
                                  jfed.predict(jmodel, x[:80]))
    _trees_equal(load_forest_trees(pdir, device="cpu"), trees)


@pytest.mark.parametrize("task,stream", [("classification", False),
                                         ("regression", False),
                                         ("classification", True)])
def test_fingerprint_equal_to_jax(task, stream):
    x, y = _data(task)
    p = dict(KW, task=task, frontier_cap="auto", trees_per_batch="auto")
    if stream:
        blocks, _, _ = make_party_views(x, y, 2, overlap=0.8, seed=2)
        fed = Federation(parties=2, n_bins=16, device="cpu")
        fed.ingest([ArraySource(b) for b in blocks], chunk_rows=50)
        jfed = JFederation(parties=2, n_bins=16)
        jfed.ingest([JBlock(name=b.name, x=b.x, ids=b.ids, y=b.y,
                            feature_ids=b.feature_ids) for b in blocks])
    else:
        fed, jfed = _fed(x, y), _jfed(x, y)
    model = fed.fit(ForestParams(**p))
    jmodel = jfed.fit(JParams(**p))
    assert repr(model.params) == repr(jmodel.params)
    got = model._fit_fingerprint(fed._partition, fed.labels_)
    assert got == jmodel._fit_fingerprint(jfed._partition, jfed.labels_)
    assert got != model._fit_fingerprint(fed._partition, fed.labels_[::-1])


def test_jax_resumable_checkpoint_resumed_by_port(tmp_path, built):
    """JAX fits 4 trees into a checkpoint; the port resumes it to 6 and
    builds only the 2 new trees; the forest equals JAX's from-scratch
    6-tree fit, and the port's chunk files equal JAX's."""
    x, y = _data()
    ck = str(tmp_path / "ck")
    jfed = _jfed(x, y)
    jfed.fit_resumable(JParams(**KW), ck, trees_per_chunk=2)
    six = dict(KW, n_estimators=6)
    jref = jfed.fit(JParams(**six))
    fed = _fed(x, y)
    model = fed.fit_resumable(ForestParams(**six), ck, trees_per_chunk=2)
    assert built["trees"] == 2
    _trees_equal(model.trees_, jref.trees_)
    np.testing.assert_array_equal(fed.predict(model, x[:60]),
                                  jfed.predict(jref, x[:60]))
    jfed.fit_resumable(JParams(**six), str(tmp_path / "jck"),
                       trees_per_chunk=2)
    for step in (2, 4, 6):
        assert _step_files(ck, step) == _step_files(tmp_path / "jck", step)


# ----------------------------------------------------------- inside the port
def test_fit_resumable_extend_slice_ahead_and_crash(tmp_path, built):
    x, y = _data()
    fed = _fed(x, y)
    ck = str(tmp_path / "ck")
    small, big = (ForestParams(**dict(KW, n_estimators=n)) for n in (2, 5))
    m_small = fed.fit_resumable(small, ck, trees_per_chunk=2)
    assert built["trees"] == 2 and ckpt.latest_step(ck) == 2
    m_big = fed.fit_resumable(big, ck, trees_per_chunk=2, model=m_small)
    assert m_big is m_small and built["trees"] == 5
    assert sorted(os.listdir(ck)) == ["step_00000002", "step_00000004",
                                      "step_00000005"]
    ref = fed.fit(big)
    built["trees"] = 0
    _trees_equal(m_big.trees_, ref.trees_)
    # slice ahead: a 3-tree fit reads the 5-tree checkpoint, builds nothing
    three = fed.fit_resumable(ForestParams(**dict(KW, n_estimators=3)), ck)
    assert built["trees"] == 0
    _trees_equal(three.trees_, fed.fit(ForestParams(**dict(
        KW, n_estimators=3))).trees_)
    # a lost chunk: resume after the last complete one
    built["trees"] = 0
    shutil.rmtree(pathlib.Path(ck) / "step_00000005")
    again = fed.fit_resumable(big, ck, trees_per_chunk=2)
    assert built["trees"] == 1
    _trees_equal(again.trees_, ref.trees_)
    meta = ckpt.read_meta(ck, 5)
    assert meta == {"family": "forest", "fingerprint": meta["fingerprint"]}


def test_fit_resumable_restarts_on_new_fingerprint(tmp_path, built):
    x, y = _data(n=300)
    blocks, _, _ = make_party_views(x, y, 2, overlap=1.0, seed=31)
    fed = Federation(parties=2, n_bins=16, device="cpu")
    fed.ingest([ArraySource(b) for b in blocks])
    p = ForestParams(**dict(KW, n_estimators=3))
    ck = str(tmp_path / "ck")
    fed.fit_resumable(p, ck, trees_per_chunk=1)
    extra = [type(b)(name=b.name, x=b.x[:30] + 0.5,
                     ids=np.array([f"e{i}" for i in range(30)]),
                     y=None if b.y is None else b.y[:30],
                     feature_ids=b.feature_ids) for b in blocks]
    fed.ingest_append([ArraySource(b) for b in extra])
    built["trees"] = 0
    resumed = fed.fit_resumable(p, ck, trees_per_chunk=1)
    assert built["trees"] == 3                    # all rebuilt
    _trees_equal(resumed.trees_, fed.fit(p).trees_)
    # other params change the fingerprint too
    built["trees"] = 0
    fed.fit_resumable(ForestParams(**dict(KW, n_estimators=3, seed=4)), ck)
    assert built["trees"] == 3


def test_load_errors_and_decode(tmp_path):
    x, y = _data()
    fed = _fed(x, y)
    model = fed.fit(ForestParams(**KW))
    ck = str(tmp_path / "ck")
    fed.save(model, ck)
    loaded = _fed(x, y).load(ck, ForestParams(**KW))
    np.testing.assert_array_equal(loaded.predict(x[:50]),
                                  model.predict(x[:50]))
    ckpt.save_checkpoint(tmp_path / "boost", 4, model.trees_,
                         meta={"family": "boosting"})
    with pytest.raises(ValueError, match="holds a 'boosting' model"):
        fed.load(str(tmp_path / "boost"), ForestParams(**KW))
    with pytest.raises(TypeError, match="ForestParams"):
        fed.load(ck, object())
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        fed.load(str(tmp_path / "empty"), ForestParams(**KW))
    with pytest.raises(ValueError, match="partition has 3"):
        fed.load(ck, ForestParams(**KW),
                 partition=_fed(x, y, parties=3)._partition)
    with pytest.raises(TypeError, match="fitted forest"):
        fed.save(object(), ck)
    ckpt.save_checkpoint(tmp_path / "bare", 1, {"w": np.zeros(2)})
    with pytest.raises(ValueError, match="not a bare PartyTree"):
        load_forest_trees(str(tmp_path / "bare"), device="cpu")
    with pytest.raises(TypeError, match="forest-only"):
        fed.fit_resumable(object(), ck)


def test_masked_regression_fit_resumable_equals_fit(tmp_path, built):
    """mask_regression=True: fit_resumable trains masked trees through the
    same set-up as fit, so it equals fit bit for bit — also when resumed
    after a lost chunk — and its predictions decode to the targets' scale."""
    x, y = _data("regression")
    fed = _fed(x, y)
    p = ForestParams(**dict(KW, task="regression"))
    ck = str(tmp_path / "ck")
    model = fed.fit_resumable(p, ck, trees_per_chunk=2, mask_regression=True)
    ref = fed.fit(p, mask_regression=True)
    _trees_equal(model.trees_, ref.trees_)
    np.testing.assert_array_equal(model.predict(x[:40]), ref.predict(x[:40]))
    assert not np.array_equal(ref.trees_.leaf_stats.numpy(),
                              fed.fit(p).trees_.leaf_stats.numpy())
    shutil.rmtree(pathlib.Path(ck) / "step_00000004")
    built["trees"] = 0
    again = fed.fit_resumable(p, ck, trees_per_chunk=2, mask_regression=True)
    assert built["trees"] == 2
    _trees_equal(again.trees_, ref.trees_)
    loaded = _fed(x, y).load(ck, p, mask_regression=True)
    np.testing.assert_array_equal(loaded.predict(x[:40]), ref.predict(x[:40]))


def test_jax_masked_regression_checkpoint_not_resumed(tmp_path, built):
    """The JAX package's fit_resumable trains this case on unmasked targets;
    the port's fingerprint differs for it alone, so the port restarts from
    scratch instead of resuming JAX's unmasked trees."""
    x, y = _data("regression")
    p = dict(KW, task="regression")
    ck = str(tmp_path / "ck")
    _jfed(x, y).fit_resumable(JParams(**p), ck, trees_per_chunk=2,
                              mask_regression=True)
    fed = _fed(x, y)
    model = fed.fit_resumable(ForestParams(**p), ck, trees_per_chunk=2,
                              mask_regression=True)
    assert built["trees"] == 4                     # all rebuilt
    _trees_equal(model.trees_,
                 fed.fit(ForestParams(**p), mask_regression=True).trees_)


@pytest.mark.parametrize("task,mask", [("classification", True),
                                       ("regression", False)])
def test_fingerprint_differs_from_jax_for_masked_regression_alone(task, mask):
    x, y = _data(task)
    p = dict(KW, task=task)
    fed, jfed = _fed(x, y), _jfed(x, y)

    def prints(flag):
        model = fed.fit(ForestParams(**p), mask_regression=flag)
        jmodel = jfed.fit(JParams(**p), mask_regression=flag)
        return (model._fit_fingerprint(fed._partition, fed.labels_),
                jmodel._fit_fingerprint(jfed._partition, jfed.labels_))
    got, want = prints(mask)
    assert got == want
    if task == "regression":
        got, want = prints(True)
        assert got != want
