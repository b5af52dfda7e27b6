"""Streamed, out-of-core ingest in the PyTorch port, held against the JAX
package on the CPU.

The quantile sketch gives ``np.quantile``'s edges while it is exact, and
past its capacity the JAX sketch's edges and tracked ``err`` on the same
stream; merging is order-invariant.  Chunked CSV / block / product sources
ingest to the in-memory partition and the JAX package's
``streaming_ingest``, whatever the chunk size; ``ingest_append`` equals a
from-scratch ingest of the union; the knobs and the product contracts fail
loudly."""
import numpy as np
import pytest

from repro.core.partyblock import PartyBlock as JBlock
from repro.streaming import ArraySource as JArraySource
from repro.streaming import QuantileSketch as JSketch
from repro.streaming import streaming_ingest as j_streaming_ingest
from repro_torch import convert
from repro_torch.core.binning import quantile_boundaries
from repro_torch.core.party import partition_from_blocks
from repro_torch.core.partyblock import PartyBlock
from repro_torch.core.types import ForestParams
from repro_torch.data import (make_classification, make_party_views,
                              make_regression)
from repro_torch.federation import Federation
from repro_torch.streaming import (ArraySource, ChunkedCSVSource, DataProduct,
                                   FeatureSketches, ProductSchema,
                                   QuantileSketch, streaming_ingest)

M = 3


def _fed(n_bins=8):
    return Federation(parties=M, n_bins=n_bins, device="cpu")


def _parts_equal(a, b):
    np.testing.assert_array_equal(a.xb, b.xb)
    np.testing.assert_array_equal(a.feat_gid, b.feat_gid)
    np.testing.assert_array_equal(a.boundaries, b.boundaries)
    assert a.n_features == b.n_features
    assert a.party_names == b.party_names


def _trees_equal(a, b):
    ta, tb = (convert.party_trees_to_numpy(m.trees_) for m in (a, b))
    for f in ta:
        np.testing.assert_array_equal(ta[f], tb[f], err_msg=f)


def _as_jax(block):
    return JBlock(name=block.name, x=block.x, ids=block.ids, y=block.y,
                  feature_ids=block.feature_ids,
                  feature_names=block.feature_names)


# ------------------------------------------------------------------ sketches
def test_sketch_exact_regime_equal_to_np_quantile_and_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(500, 4)) * [1.0, 10.0, 0.1, 100.0]
    fs = FeatureSketches(4, capacity=512)
    for lo in range(0, 500, 37):                  # ragged chunks
        fs.update(x[lo:lo + 37])
    assert fs.exact and fs.err == 0 and fs.n == 500
    np.testing.assert_array_equal(fs.edges(16), quantile_boundaries(x, 16))
    js = [JSketch(512).update(x[:, f]) for f in range(4)]
    np.testing.assert_array_equal(fs.edges(16),
                                  np.stack([s.edges(16) for s in js]))
    fs2 = FeatureSketches(4, capacity=512)
    for lo in reversed(range(0, 500, 23)):        # order cannot matter
        fs2.update(x[lo:lo + 23])
    np.testing.assert_array_equal(fs.edges(16), fs2.edges(16))


@pytest.mark.parametrize("chunk,seed", [(64, 1), (173, 2), (512, 3)])
def test_sketch_compacted_regime_equal_to_jax(chunk, seed):
    """Past capacity: the same compactions as the JAX sketch, so the same
    levels, the same tracked ``err`` and the same edges — sequential and
    merged (both merge orders)."""
    rng = np.random.default_rng(seed)
    n, k = 6000, 64
    data = np.concatenate([rng.normal(size=n // 2),
                           rng.exponential(size=n // 2) * 40.0])
    rng.shuffle(data)

    def build(cls):
        seq, parts = cls(capacity=k), []
        for lo in range(0, n, chunk):
            seq.update(data[lo:lo + chunk])
            parts.append(cls(capacity=k).update(data[lo:lo + chunk]))
        fwd = parts[0]
        for p in parts[1:]:
            fwd = fwd.merge(p)
        rev = parts[-1]
        for p in reversed(parts[:-1]):
            rev = p.merge(rev)
        return seq, fwd, rev

    qs = np.linspace(0.0, 1.0, 17)[1:-1]
    data_sorted = np.sort(data)
    for got, want in zip(build(QuantileSketch), build(JSketch)):
        assert got.n == want.n == n
        assert got.err == want.err and 0 < got.err
        assert not got.exact
        for lg, lw in zip(got.levels, want.levels, strict=True):
            np.testing.assert_array_equal(lg, lw)
        np.testing.assert_array_equal(got.edges(32), want.edges(32))
        np.testing.assert_array_equal(got.quantiles(qs), want.quantiles(qs))
        for q, v in zip(qs, got.quantiles(qs)):   # err is a real bound
            lo = np.searchsorted(data_sorted, v, side="left")
            hi = np.searchsorted(data_sorted, v, side="right")
            assert lo - (got.err + 1) <= q * (n - 1) <= hi + (got.err + 1)


def test_sketch_merge_exact_regime_is_order_invariant():
    rng = np.random.default_rng(7)
    chunks = [rng.normal(size=s) for s in (40, 11, 96, 3)]
    sks = [QuantileSketch(capacity=256).update(c) for c in chunks]
    a = sks[0].merge(sks[1]).merge(sks[2]).merge(sks[3])
    b = sks[3].merge(sks[2]).merge(sks[1]).merge(sks[0])
    assert a.exact and b.exact
    qs = np.linspace(0, 1, 9)[1:-1]
    np.testing.assert_array_equal(a.quantiles(qs), b.quantiles(qs))
    np.testing.assert_array_equal(a.quantiles(qs),
                                  np.quantile(np.concatenate(chunks), qs))


@pytest.mark.parametrize("make,match", [
    (lambda: QuantileSketch(capacity=8).update([1.0, np.nan]), "non-finite"),
    (lambda: QuantileSketch(capacity=4), "capacity must be >= 8"),
    (lambda: QuantileSketch().quantiles([0.5]), "empty sketch"),
    (lambda: FeatureSketches(3).update(np.zeros((4, 2))), r"\(n, 3\) chunk"),
    (lambda: FeatureSketches(3).merge(FeatureSketches(2)), "3 vs 2"),
])
def test_sketch_errors(make, match):
    with pytest.raises(ValueError, match=match):
        make()


# ------------------------------------------------- streamed ingest (local)
@pytest.mark.parametrize("task", ["classification", "regression"])
def test_streamed_ingest_equal_to_in_memory_and_jax(task, tmp_path):
    """Chunked CSV + block sources, shuffled rows, partial overlap: the
    streamed build equals partition_from_blocks and the JAX package's
    streaming_ingest, and the fit after it equals the in-memory one."""
    if task == "classification":
        x, y = make_classification(260, 9, 3, seed=5)
    else:
        x, y = make_regression(260, 9, seed=5)
    blocks, _, _ = make_party_views(x, y, M, overlap=0.8, seed=5)
    ref_part, ref_y, ref_ids = partition_from_blocks(blocks, n_bins=16)

    sources = [ChunkedCSVSource(b.to_csv(str(tmp_path / f"{b.name}.csv")),
                                name=b.name)
               for b in blocks[:-1]] + [ArraySource(blocks[-1])]
    fed = _fed(16)
    part = fed.ingest(sources, chunk_rows=29)
    _parts_equal(part, ref_part)
    assert part.raw_parts is None
    np.testing.assert_array_equal(fed.labels_, ref_y)
    np.testing.assert_array_equal(fed.aligned_ids_, ref_ids)

    jpart, jy, jids, _ = j_streaming_ingest(
        [JArraySource(_as_jax(b)) for b in blocks], 16, chunk_rows=29)
    _parts_equal(part, jpart)
    np.testing.assert_array_equal(fed.labels_, jy)
    np.testing.assert_array_equal(fed.aligned_ids_, jids)

    p = ForestParams(task=task, n_estimators=2, max_depth=3, n_bins=16,
                     n_classes=3, seed=3)
    ref_fed = _fed(16)
    ref_fed.ingest(blocks)
    _trees_equal(fed.fit(p), ref_fed.fit(p))


@pytest.mark.parametrize("rows", [1, 7, 64, 4096])
def test_streamed_ingest_chunk_size_invariance(rows):
    x, y = make_classification(150, 6, 2, seed=11)
    blocks, _, _ = make_party_views(x, y, M, overlap=0.9, seed=11)
    ref, ref_y, _ = partition_from_blocks(blocks, n_bins=8)
    fed = _fed()
    part = fed.ingest([ArraySource(b) for b in blocks], chunk_rows=rows)
    _parts_equal(part, ref)
    np.testing.assert_array_equal(fed.labels_, ref_y)


def test_streaming_ingest_entry_point_and_pre_aligned_fast_path():
    """The one-call entry point keeps caller row order when every party
    lists the same IDs in the same order (no hashing reorder)."""
    x, y = make_classification(90, 6, 2, seed=3)
    ids = np.array([f"r{i}" for i in range(90)])
    blocks = [PartyBlock("a", x[:, :3], ids=ids, y=y),
              PartyBlock("b", x[:, 3:], ids=ids)]
    part, yy, common, streams = streaming_ingest(
        [ArraySource(b) for b in blocks], 8, chunk_rows=20)
    np.testing.assert_array_equal(common, ids)
    np.testing.assert_array_equal(yy, y)
    _parts_equal(part, partition_from_blocks(blocks, 8)[0])
    assert [st.name for st in streams] == ["a", "b"]
    with pytest.raises(ValueError, match="validate=True"):
        streaming_ingest([ArraySource(b) for b in blocks], 8, validate=True)


@pytest.mark.parametrize("call,match", [
    (lambda fed, b, y: fed.ingest(b, chunk_rows=16), "chunked sources"),
    (lambda fed, b, y: fed.ingest(b, sketch_capacity=64), "chunked sources"),
    (lambda fed, b, y: fed.ingest([ArraySource(x) for x in b], y=y),
     "y/contiguous/seed"),
    (lambda fed, b, y: fed.ingest([ArraySource(b[0])]), "declares 3"),
    (lambda fed, b, y: fed.ingest_append([ArraySource(b[0])]),
     "ingest_append extends"),
])
def test_streamed_ingest_knob_errors(call, match):
    x, y = make_classification(60, 6, 2, seed=0)
    blocks, _, _ = make_party_views(x, y, M, seed=0)
    with pytest.raises(ValueError, match=match):
        call(_fed(), blocks, y)


def test_chunked_csv_nan_row_index_is_global(tmp_path):
    f = tmp_path / "nan.csv"
    f.write_text("id,a\n" + "".join(f"u{i},{i}.5\n" for i in range(7))
                 + "u7,nan\n")
    with pytest.raises(ValueError, match=r"'a'.*data row 7"):
        for _ in ChunkedCSVSource(str(f)).iter_chunks(3):
            pass


# ----------------------------------------------------------- incremental
def test_ingest_append_matches_from_scratch():
    """Appended rows re-assemble to exactly the from-scratch union build;
    the fit after the append equals the fit of the union."""
    x, y = make_classification(200, 6, 2, seed=21)
    blocks, _, _ = make_party_views(x, y, M, overlap=1.0, seed=21)
    x2, y2 = make_classification(80, 6, 2, seed=22)
    blocks2, _, _ = make_party_views(x2, y2, M, overlap=1.0, seed=21)
    blocks2 = [PartyBlock(name=b.name, x=b.x,
                          ids=np.array([f"new{i}" for i in range(len(b.ids))]),
                          y=b.y, feature_ids=b.feature_ids)
               for b in blocks2]
    union = [PartyBlock(name=a.name, x=np.concatenate([a.x, b.x]),
                        ids=np.concatenate([a.ids, b.ids]),
                        y=None if a.y is None else np.concatenate([a.y, b.y]),
                        feature_ids=a.feature_ids)
             for a, b in zip(blocks, blocks2)]
    ref_part, ref_y, ref_ids = partition_from_blocks(union, n_bins=16)

    fed = _fed(16)
    fed.ingest([ArraySource(b) for b in blocks], chunk_rows=33)
    part = fed.ingest_append([ArraySource(b) for b in blocks2])
    _parts_equal(part, ref_part)
    np.testing.assert_array_equal(fed.labels_, ref_y)
    np.testing.assert_array_equal(fed.aligned_ids_, ref_ids)

    p = ForestParams(n_estimators=3, max_depth=3, n_bins=16, seed=9)
    ref_fed = _fed(16)
    ref_fed.ingest(union)
    _trees_equal(fed.fit(p), ref_fed.fit(p))


# -------------------------------------------------------------- data products
def _bank():
    rng = np.random.default_rng(0)
    return PartyBlock("bank", rng.normal(size=(20, 3)),
                      ids=[f"u{i}" for i in range(20)])


@pytest.mark.parametrize("schema,match", [
    (ProductSchema(n_features=4), "declared 4 features"),
    (ProductSchema(n_features=3, feature_dtype="float32"),
     "declared feature dtype"),
    (ProductSchema(n_features=3, id_kind="int"), "ID contract"),
    (ProductSchema(n_features=3, has_labels=True), "has_labels"),
    (ProductSchema(n_features=3, feature_ids=(0, 1, 2)), "feature_ids"),
])
def test_data_product_schema_validated_loudly(schema, match):
    b = _bank()
    good = DataProduct("bank", ArraySource(b), ProductSchema.of(b))
    assert sum(c.n_samples for c in good.iter_chunks(7)) == 20
    with pytest.raises(ValueError, match=match):
        list(DataProduct("bank", ArraySource(b), schema).iter_chunks(7))


@pytest.mark.parametrize("make,match", [
    (lambda b: list(DataProduct("ecom", ArraySource(b),
                                ProductSchema.of(b)).iter_chunks(7)),
     "carry the product name"),
    (lambda b: DataProduct("bank", ArraySource(b), ProductSchema.of(b),
                           version=-1), "version must be >= 0"),
    (lambda b: ProductSchema(n_features=3, id_kind="uuid"), "id_kind"),
])
def test_data_product_contract_errors(make, match):
    with pytest.raises(ValueError, match=match):
        make(_bank())


def test_data_product_versions_must_advance():
    x, y = make_classification(90, 6, 2, seed=41)
    blocks, _, _ = make_party_views(x, y, M, overlap=1.0, seed=41)
    fed = _fed()
    fed.ingest([DataProduct(b.name, ArraySource(b), ProductSchema.of(b),
                            version=1) for b in blocks])
    b0 = blocks[0]
    new_rows = PartyBlock(name=b0.name, x=b0.x[:5],
                          ids=np.array([f"v{i}" for i in range(5)]),
                          y=None if b0.y is None else b0.y[:5],
                          feature_ids=b0.feature_ids)
    with pytest.raises(ValueError, match="does not advance"):
        fed.ingest_append([DataProduct(b0.name, ArraySource(new_rows),
                                       ProductSchema.of(b0), version=1)])
    with pytest.raises(ValueError, match="cannot add new ones"):
        fed.ingest_append([ArraySource(PartyBlock(
            "stranger", np.zeros((2, 1)), ids=["a", "b"]))])
    part = fed.ingest_append([DataProduct(b0.name, ArraySource(new_rows),
                                          ProductSchema.of(b0), version=2)])
    # rows join the training set only once every party holds them
    assert part.n_samples == 90
    assert fed._stream["streams"][0].version == 2


# ------------------------------------------------------------------- parquet
def _block_to_parquet(b, path):
    """Write a PartyBlock as parquet with to_csv's column semantics
    (gf<N> feature headers, id first, label last)."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    names = tuple(f"gf{j}" for j in b.feature_ids) \
        if b.feature_ids is not None \
        else (b.feature_names or tuple(f"f{j}" for j in range(b.n_features)))
    cols = {"id": pa.array(np.asarray(b.ids))}
    for j, name in enumerate(names):
        cols[name] = pa.array(np.asarray(b.x[:, j], dtype=np.float64))
    if b.y is not None:
        cols["label"] = pa.array(np.asarray(b.y))
    pq.write_table(pa.table(cols), path)
    return path


def _chunks_equal(a, q):
    np.testing.assert_array_equal(a.x, q.x)
    np.testing.assert_array_equal(np.asarray(a.ids, dtype=str),
                                  np.asarray(q.ids, dtype=str))
    if a.y is None:
        assert q.y is None
    else:
        np.testing.assert_array_equal(a.y, q.y)
    np.testing.assert_array_equal(a.feature_ids, q.feature_ids)
    assert a.feature_names == q.feature_names


def test_parquet_source_chunks_equal_jax_and_csv_source(tmp_path):
    """The port's Parquet chunks equal the JAX package's on the same file,
    and the port's CSV chunks of the same block."""
    from repro.streaming import ChunkedParquetSource as JParquet
    from repro_torch.streaming import ChunkedParquetSource
    x, y = make_classification(110, 6, 2, seed=23)
    blocks, _, _ = make_party_views(x, y, M, overlap=0.9, seed=23)
    for b in blocks[:2]:                         # with and without labels
        path = _block_to_parquet(b, str(tmp_path / f"{b.name}.parquet"))
        csv_src = ChunkedCSVSource(b.to_csv(str(tmp_path / f"{b.name}.csv")),
                                   name="p")
        src, jsrc = ChunkedParquetSource(path, name="p"), JParquet(path,
                                                                   name="p")
        for rows in (7, 1000):
            pc, jc = list(src.iter_chunks(rows)), list(jsrc.iter_chunks(rows))
            cc = list(csv_src.iter_chunks(rows))
            assert len(pc) == len(jc) == len(cc)
            for a, q, c in zip(pc, jc, cc):
                _chunks_equal(a, q)
                np.testing.assert_array_equal(a.ids, q.ids)
                assert a.ids.dtype == q.ids.dtype and a.x.dtype == q.x.dtype
                _chunks_equal(c, a)
        with pytest.raises(ValueError, match=">= 1"):
            next(src.iter_chunks(0))


def test_parquet_streamed_ingest_bit_identical_to_in_memory(tmp_path):
    """Parquet extracts streamed in 31-row chunks ingest to the in-memory
    partition, labels and forest, bit for bit, and to the JAX package's
    streamed ingest of the same files."""
    from repro.streaming import ChunkedParquetSource as JParquet
    from repro_torch.streaming import ChunkedParquetSource
    x, y = make_classification(150, 9, 3, seed=29)
    blocks, _, _ = make_party_views(x, y, M, overlap=0.8, seed=29)
    ref, ref_y, _ = partition_from_blocks(blocks, n_bins=8)
    paths = [_block_to_parquet(b, str(tmp_path / f"{b.name}.parquet"))
             for b in blocks]
    fed = _fed()
    part = fed.ingest([ChunkedParquetSource(p, name=b.name)
                       for p, b in zip(paths, blocks)], chunk_rows=31)
    _parts_equal(part, ref)
    np.testing.assert_array_equal(fed.labels_, ref_y)
    jpart, jy, _, _ = j_streaming_ingest(
        [JParquet(p, name=b.name) for p, b in zip(paths, blocks)], 8,
        chunk_rows=31)
    _parts_equal(part, jpart)
    np.testing.assert_array_equal(fed.labels_, jy)
    mem = _fed()
    mem.ingest(blocks)
    p = ForestParams(n_estimators=2, max_depth=3, n_bins=8, n_classes=3,
                     seed=1)
    _trees_equal(fed.fit(p), mem.fit(p))


def test_parquet_empty_file_yields_one_empty_chunk(tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as pq
    from repro_torch.streaming import ChunkedParquetSource
    t = pa.table({"id": pa.array([], type=pa.int64()),
                  "gf0": pa.array([], type=pa.float64()),
                  "gf1": pa.array([], type=pa.float64())})
    pq.write_table(t, str(tmp_path / "empty.parquet"))
    chunks = list(ChunkedParquetSource(
        str(tmp_path / "empty.parquet")).iter_chunks(16))
    assert len(chunks) == 1
    assert chunks[0].x.shape == (0, 2) and chunks[0].ids.shape == (0,)
    assert chunks[0].name == "empty"
    np.testing.assert_array_equal(chunks[0].feature_ids, [0, 1])


def test_distributed_substrate_refuses_parquet_source(tmp_path):
    """The party-per-process substrate ships no Parquet source to a worker:
    the JAX package's TypeError, word for word."""
    from repro.federation import distributed as jdist
    from repro.streaming import ChunkedParquetSource as JParquet
    from repro_torch.federation import distributed
    from repro_torch.streaming import ChunkedParquetSource
    path = str(tmp_path / "p.parquet")
    with pytest.raises(TypeError) as got:
        distributed._stream_source_spec(ChunkedParquetSource(path))
    with pytest.raises(TypeError) as want:
        jdist._stream_source_spec(JParquet(path))
    assert str(got.value) == str(want.value)
    assert "ChunkedParquetSource" in str(got.value)
