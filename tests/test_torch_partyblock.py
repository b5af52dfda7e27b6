"""Party-first ingest in the PyTorch port, held against the JAX package.

Inside the port (on the CPU): M-party hashed-ID alignment puts every party
on one canonical ordering and fails loudly; shuffled, superset party blocks
ingest to the partition, labels and forest of the centrally pre-aligned
matrix; the CSV round trip and the raw-matrix adapter keep their contracts.
Against the JAX package: ``make_party_views``, ``partition_from_blocks``,
``raw_party_rows`` / ``bin_party_blocks`` and a party-first fit give the
same arrays, bit for bit, from the same seeded inputs."""
import numpy as np
import pytest

from repro.core import crypto as jcrypto
from repro.core.party import partition_from_blocks as j_from_blocks
from repro.core.partyblock import PartyBlock as JBlock
from repro.core.types import ForestParams as JParams
from repro.data import make_party_views as j_party_views
from repro.federation import Federation as JFederation
from repro_torch import convert
from repro_torch.core import crypto
from repro_torch.core.party import partition_from_blocks
from repro_torch.core.partyblock import CSVSource, PartyBlock
from repro_torch.core.types import ForestParams
from repro_torch.data import (make_classification, make_party_views,
                              make_regression)
from repro_torch.federation import Federation


def _fed(parties, n_bins=8, **kw):
    return Federation(parties=parties, n_bins=n_bins, device="cpu", **kw)


def _trees(model):
    return convert.party_trees_to_numpy(model.trees_)


def _trees_equal(a, b):
    for f, x in _trees(a).items():
        np.testing.assert_array_equal(x, _trees(b)[f], err_msg=f)


def _parts_equal(a, b, raw=True):
    np.testing.assert_array_equal(a.xb, b.xb)
    np.testing.assert_array_equal(a.feat_gid, b.feat_gid)
    np.testing.assert_array_equal(a.boundaries, b.boundaries)
    assert a.n_features == b.n_features
    if raw:
        for ra, rb in zip(a.raw_parts, b.raw_parts):
            np.testing.assert_array_equal(ra, rb)


def _as_jax(block):
    return JBlock(name=block.name, x=block.x, ids=block.ids, y=block.y,
                  feature_ids=block.feature_ids,
                  feature_names=block.feature_names)


# --------------------------------------------------- M-party alignment core
def test_align_ids_multiparty_canonical_order():
    rng = np.random.default_rng(0)
    ids = np.array([f"u{i}" for i in range(40)])
    views = [rng.permutation(ids) for _ in range(3)]
    hashed = [crypto.hash_ids(v) for v in views]
    pos = crypto.align_ids(*hashed)
    ref = views[0][pos[0]]
    for v, p in zip(views, pos):
        np.testing.assert_array_equal(v[p], ref)
    np.testing.assert_array_equal(crypto.hash_ids(ref),
                                  np.sort(crypto.hash_ids(ids)))
    np.testing.assert_array_equal(views[2][crypto.align_ids(*hashed[::-1])[0]],
                                  ref)
    for got, want in zip(pos, jcrypto.align_ids(*hashed)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hashes,names,match", [
    ([["a", "b", "a"]], ["p"], "party 'p' has duplicate"),
    ([["a"], ["z"]], ["p", "q"], "intersection across parties"),
    ([[], []], ["p", "q"], "intersection across parties"),   # fast path
])
def test_align_hashed_errors(hashes, names, match):
    hs = [np.array(h, dtype="<U1") for h in hashes]
    with pytest.raises(ValueError, match=match):
        crypto.align_hashed(hs, names)
    with pytest.raises(ValueError, match=match):
        jcrypto.align_hashed(hs, names)


def test_align_hashed_equal_to_jax():
    a = crypto.hash_ids(np.arange(0, 30))
    b = crypto.hash_ids(np.arange(10, 40)[::-1])
    for fast in (True, False):
        got = crypto.align_hashed([a, b], ["p", "q"], identity_fast_path=fast)
        want = jcrypto.align_hashed([a, b], ["p", "q"],
                                    identity_fast_path=fast)
        for g, w in zip(got[0], want[0]):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(got[1], want[1])
    pos, common = crypto.align_hashed([a, a.copy()], ["p", "q"])
    np.testing.assert_array_equal(pos[1], np.arange(30))
    np.testing.assert_array_equal(common, a)


def test_hash_ids_cache_bit_identity():
    crypto._HASH_CACHE.clear()
    ids = np.array([f"u{i}" for i in range(50)])
    cold = crypto.hash_ids(ids)
    assert len(crypto._HASH_CACHE) >= 50
    warm = crypto.hash_ids(np.concatenate([ids, ids]))
    np.testing.assert_array_equal(warm[:50], cold)
    np.testing.assert_array_equal(warm[50:], cold)
    np.testing.assert_array_equal(cold, jcrypto.hash_ids(ids))
    assert not np.array_equal(crypto.hash_ids(ids, salt="other"), cold)


# ------------------------------------------------------------ loud errors
_A = dict(name="a", x=np.zeros((3, 2)), ids=["1", "2", "3"], y=[0, 1, 0])


@pytest.mark.parametrize("blocks,kw,match", [
    ([_A, dict(name="b", x=np.zeros((2, 2)), ids=["8", "9"])], {},
     "intersection"),
    ([_A, dict(name="b", x=np.zeros((3, 2)), ids=["1", "1", "3"])], {},
     "duplicate"),
    ([_A, dict(name="b", x=np.zeros((3, 2)), ids=["1", "2", "3"])],
     {"y": np.zeros(3)}, "labels ride"),
    ([_A], {}, "declares 2"),
    ([_A, dict(name="b", x=np.zeros((3, 2)), ids=["1", "2", "3"],
               y=[1, 0, 1])], {}, "more than one party"),
    ([_A, dict(name="a", x=np.zeros((3, 2)), ids=["1", "2", "3"])], {},
     "unique"),
    ([_A, dict(name="b", x=np.zeros((3, 2)), ids=["1", "2", "3"])],
     {"contiguous": False}, "raw-matrix"),
    ([_A, dict(name="b", x=np.zeros((3, 2)), ids=["1", "2", "3"])],
     {"seed": 7}, "raw-matrix"),
    ([dict(name="a", x=np.empty((0, 2)), ids=np.empty(0, dtype="<U4")),
      dict(name="b", x=np.empty((0, 3)), ids=np.empty(0, dtype="<U4"))], {},
     "intersection"),
])
def test_ingest_errors_are_loud(blocks, kw, match):
    with pytest.raises(ValueError, match=match):
        _fed(2).ingest([PartyBlock(**b) for b in blocks], **kw)
    with pytest.raises(ValueError, match=match):
        JFederation(parties=2).ingest([JBlock(**b) for b in blocks], **kw)


def test_ingest_rejects_a_bare_block():
    with pytest.raises(TypeError, match="as a sequence"):
        _fed(2).ingest(PartyBlock(**_A))


@pytest.mark.parametrize("make,match", [
    (lambda: PartyBlock("p", np.zeros((3, 2)), ids=["1", "2"]),
     "sample IDs for"),
    (lambda: PartyBlock("p", np.zeros((3, 2)), ids=["1", "2", "3"], y=[1]),
     "labels for"),
    (lambda: PartyBlock("p", np.zeros(3), ids=["1", "2", "3"]),
     "must be"),
    (lambda: partition_from_blocks(
        [PartyBlock("a", np.zeros((2, 1)), ids=["1", "2"], feature_ids=[0]),
         PartyBlock("b", np.zeros((2, 1)), ids=["1", "2"])], 4),
     "feature_ids must be set"),
    (lambda: partition_from_blocks(
        [PartyBlock("a", np.zeros((2, 1)), ids=["1", "2"], feature_ids=[0]),
         PartyBlock("b", np.zeros((2, 1)), ids=["1", "2"],
                    feature_ids=[2])], 4),
     "partition 0..F-1"),
])
def test_block_validation(make, match):
    with pytest.raises(ValueError, match=match):
        make()


# ------------------------------------------- losslessness under real ingest
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("contiguous", [True, False])
def test_partition_from_blocks_equal_to_dense_and_jax(seed, contiguous):
    """Shuffled rows, permuted party order, disjoint extra samples per
    party: the aligned partition equals the dense pre-aligned build and the
    JAX package's, bit for bit (validate=True re-bins centrally)."""
    x, y = make_classification(260, 11, 2, seed=seed)
    blocks, xa, ya = make_party_views(x, y, 3, overlap=0.7,
                                      contiguous=contiguous, seed=seed)
    jblocks, jxa, jya = j_party_views(x, y, 3, overlap=0.7,
                                      contiguous=contiguous, seed=seed)
    for b, jb in zip(blocks, jblocks):
        assert b.name == jb.name
        for f in ("x", "ids", "y", "feature_ids"):
            np.testing.assert_array_equal(getattr(b, f), getattr(jb, f))
    np.testing.assert_array_equal(xa, jxa)
    np.testing.assert_array_equal(ya, jya)

    order = np.random.default_rng(seed).permutation(3)
    part, yb, ids = partition_from_blocks([blocks[i] for i in order], 8,
                                          validate=True)
    dense = _fed(3, seed=seed).ingest(xa, ya, contiguous=contiguous)
    _parts_equal(part, dense)
    np.testing.assert_array_equal(yb, ya)
    np.testing.assert_array_equal(part.dense_raw(), xa)

    jpart, jy, jids = j_from_blocks([jblocks[i] for i in order], 8)
    _parts_equal(part, jpart)
    np.testing.assert_array_equal(yb, jy)
    np.testing.assert_array_equal(ids, jids)
    assert part.party_names == jpart.party_names


def test_raw_party_rows_and_bin_party_blocks_equal_jax():
    """Request blocks with shuffled rows, party-local extras and columns in
    any global-id order re-align and bin exactly as in the JAX package."""
    x, y = make_classification(200, 9, 2, seed=10)
    blocks, _, _ = make_party_views(x, y, 3, overlap=0.85, seed=10)
    part, _, _ = partition_from_blocks(blocks, 16)
    jpart, _, _ = j_from_blocks([_as_jax(b) for b in blocks], 16)
    xt, _ = make_classification(40, 9, 2, seed=77)
    qids = np.array([f"q{i}" for i in range(len(xt))])
    rng = np.random.default_rng(3)
    req = []
    for i, name in enumerate(part.party_names):
        gid = part.feat_gid[i][part.feat_gid[i] >= 0]
        rows, cols = rng.permutation(len(xt)), rng.permutation(len(gid))
        req.append(PartyBlock(
            name=name,
            x=np.concatenate([xt[rows][:, gid[cols]],
                              rng.normal(size=(4, len(gid)))]),
            ids=np.concatenate([qids[rows],
                                [f"{name}-only{j}" for j in range(4)]]),
            feature_ids=gid[cols]))
    ids, raw = part.raw_party_rows(req[::-1])
    jids, jraw = jpart.raw_party_rows([_as_jax(b) for b in req[::-1]])
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(ids, qids[np.argsort(crypto.hash_ids(qids))])
    for r, jr in zip(raw, jraw):
        np.testing.assert_array_equal(r, jr)
    ids, xb = part.bin_party_blocks(req)
    jids, jxb = jpart.bin_party_blocks([_as_jax(b) for b in req])
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(xb, jxb)
    np.testing.assert_array_equal(
        xb, part.bin_test(xt[np.argsort(crypto.hash_ids(qids))]))
    with pytest.raises(ValueError, match="cover exactly"):
        part.raw_party_rows([req[0], PartyBlock("nobody", np.zeros((2, 4)),
                                                ids=["1", "2"]), req[2]])
    with pytest.raises(ValueError, match="fit-time features"):
        part.raw_party_rows([PartyBlock(b.name, b.x, ids=b.ids,
                                        feature_ids=b.feature_ids[::-1] + 1)
                             if i == 0 else b for i, b in enumerate(req)])


@pytest.mark.parametrize("task", ["classification", "regression"])
def test_party_first_fit_equal_to_pre_aligned(task):
    """Fit from realistic PartyBlocks == fit from the central pre-aligned
    matrix in the port: the same forest and predictions, bit for bit."""
    if task == "classification":
        x, y = make_classification(300, 10, 3, seed=4)
        p = ForestParams(task=task, n_classes=3, n_estimators=4, max_depth=5,
                         n_bins=16, seed=11)
    else:
        x, y = make_regression(300, 10, seed=4)
        p = ForestParams(task=task, n_estimators=4, max_depth=5, n_bins=16,
                         seed=11)
    blocks, xa, ya = make_party_views(x, y, 3, overlap=0.75, seed=4)
    fed = _fed(3, 16)
    part = fed.ingest(blocks, validate=True)
    assert part.n_samples == len(xa)
    np.testing.assert_array_equal(fed.labels_, ya)
    model = fed.fit(p)
    fed_c = _fed(3, 16)
    fed_c.ingest(xa, ya)
    central = fed_c.fit(p)
    _trees_equal(model, central)
    np.testing.assert_array_equal(fed.predict(model, xa[:64]),
                                  fed_c.predict(central, xa[:64]))


def test_party_first_classification_fit_equal_to_jax():
    x, y = make_classification(600, 12, 2, seed=5)
    blocks, xa, _ = make_party_views(x, y, 2, overlap=0.8, seed=5)
    kw = dict(n_estimators=3, max_depth=5, n_bins=16, seed=2)
    fed = _fed(2, 16)
    fed.ingest(blocks)
    model = fed.fit(ForestParams(**kw))
    jfed = JFederation(parties=2, n_bins=16)
    jfed.ingest([_as_jax(b) for b in blocks])
    jmodel = jfed.fit(JParams(**kw))
    np.testing.assert_array_equal(fed.aligned_ids_, jfed.aligned_ids_)
    for f, a in _trees(model).items():
        np.testing.assert_array_equal(a, np.asarray(getattr(jmodel.trees_, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(fed.predict(model, xa[:50]),
                                  jfed.predict(jmodel, xa[:50]))


def test_ingest_invariant_to_party_order_and_shuffle():
    x, y = make_classification(240, 9, 2, seed=6)
    blocks, _, _ = make_party_views(x, y, 3, overlap=0.8, seed=6)
    rng = np.random.default_rng(0)
    reshuffled = []
    for b in blocks[::-1]:
        perm = rng.permutation(b.n_samples)
        reshuffled.append(PartyBlock(
            name=b.name, x=b.x[perm], ids=b.ids[perm],
            y=None if b.y is None else b.y[perm], feature_ids=b.feature_ids))
    p = ForestParams(n_estimators=2, max_depth=4, n_bins=8, seed=3)
    fed1, fed2 = _fed(3), _fed(3)
    _parts_equal(fed1.ingest(blocks), fed2.ingest(reshuffled))
    np.testing.assert_array_equal(fed1.labels_, fed2.labels_)
    np.testing.assert_array_equal(fed1.aligned_ids_, fed2.aligned_ids_)
    _trees_equal(fed1.fit(p), fed2.fit(p))


def test_raw_matrix_adapter_preserves_row_order():
    x, y = make_classification(150, 7, 2, seed=14)
    fed = _fed(2)
    part = fed.ingest(x, y, validate=True)
    np.testing.assert_array_equal(fed.aligned_ids_, np.arange(len(x)))
    np.testing.assert_array_equal(fed.labels_, y)
    np.testing.assert_array_equal(part.dense_raw(), x)
    assert part.party_names == ("party000", "party001")


# -------------------------------------------------------- DataSource / CSV
def test_csv_roundtrip_and_source(tmp_path):
    x, y = make_classification(60, 6, 2, seed=8)
    blocks, xa, ya = make_party_views(x, y, 2, overlap=0.9, seed=8)
    sources = [CSVSource(b.to_csv(str(tmp_path / f"{b.name}.csv")),
                         name=b.name) for b in blocks]
    # the port writes the JAX package's bytes
    jpath = tmp_path / "jax.csv"
    _as_jax(blocks[0]).to_csv(str(jpath))
    assert jpath.read_bytes() == (tmp_path / f"{blocks[0].name}.csv"
                                  ).read_bytes()
    loaded = sources[0].load()
    assert loaded.name == blocks[0].name
    for f in ("ids", "x", "y", "feature_ids"):
        np.testing.assert_array_equal(getattr(loaded, f),
                                      getattr(blocks[0], f))
    assert loaded.y.dtype == np.int64
    fed = _fed(2)
    part = fed.ingest(sources, validate=True)
    np.testing.assert_array_equal(part.xb, _fed(2).ingest(xa, ya).xb)
    np.testing.assert_array_equal(fed.labels_, ya)


def test_csv_roundtrip_preserves_encoding_under_name_reorder(tmp_path):
    x, y = make_classification(80, 6, 2, seed=21)
    blocks, xa, ya = make_party_views(x, y, 2, overlap=0.9, seed=21)
    renamed = [PartyBlock(name=n, x=b.x, ids=b.ids, y=b.y,
                          feature_ids=b.feature_ids)
               for n, b in zip(("zulu", "alpha"), blocks)]
    sources = [CSVSource(b.to_csv(str(tmp_path / f"{b.name}.csv")),
                         name=b.name) for b in renamed]
    direct = _fed(2).ingest(renamed)
    fed_csv = _fed(2)
    via_csv = fed_csv.ingest(sources, validate=True)
    _parts_equal(direct, via_csv)
    assert via_csv.party_names == ("alpha", "zulu")
    p = ForestParams(n_estimators=2, max_depth=4, n_bins=8, seed=2)
    fed_dense = _fed(2)
    fed_dense.ingest(xa, ya)
    np.testing.assert_array_equal(fed_csv.predict(fed_csv.fit(p), xa),
                                  fed_dense.predict(fed_dense.fit(p), xa))


def test_csv_regression_labels_keep_float_dtype(tmp_path):
    b = PartyBlock("reg", np.arange(8.0).reshape(4, 2),
                   ids=["a", "b", "c", "d"], y=[10.0, 20.0, 30.0, 40.0])
    loaded = PartyBlock.from_csv(b.to_csv(str(tmp_path / "reg.csv")))
    assert loaded.y.dtype == np.float64
    np.testing.assert_array_equal(loaded.y, b.y)


@pytest.mark.parametrize("text,match", [
    ("a,b\n1.0,2.0\n", "no 'id' column"),
    ("", "empty CSV"),
    ("id,age,income\nu1,33,50000\nu2,41,NaN\nu3,29,61000\n",
     r"'income'.*data row 1"),
    ("id,age,income\nu1,33,50000\nu2,41,1.0\nu3,,61000\n",
     r"'age'.*data row 2"),
])
def test_csv_errors_are_loud(tmp_path, text, match):
    f = tmp_path / "bad.csv"
    f.write_text(text)
    with pytest.raises(ValueError, match=match):
        PartyBlock.from_csv(str(f))
