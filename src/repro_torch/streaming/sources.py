"""Chunked party data sources — PartyBlock-shaped chunks, never the whole silo.

The in-memory plane loads one
:class:`~repro_torch.core.partyblock.PartyBlock` per party
(``DataSource.load``).  The streaming plane replaces that with a
:class:`ChunkedSource`: ``iter_chunks(rows)`` yields PartyBlock-shaped chunks
(same name / feature layout, a bounded slice of rows each), so a scan touches
``O(chunk)`` raw feature values at a time no matter how big the extract is.

:class:`ChunkedCSVSource` streams a per-party CSV through the exact parse
helpers ``PartyBlock.from_csv`` uses (core/partyblock.py: one owner of the
header layout, float parse with the loud NaN/missing contract, label dtype
rule), which is what makes a chunked read bit-identical to the whole-file
load.  :class:`ChunkedParquetSource` streams a Parquet extract through the
same header rules (it needs the optional ``pyarrow``, imported only when a
scan starts).  :class:`ArraySource` adapts an in-memory block (tests,
oracles).

:class:`DataProduct` is the data-mesh wrapper (SNIPPETS.md): a party's
published extract as a versioned product with a declared schema — feature
ids/count/dtype, the ID contract, label ownership — validated **loudly**
against every chunk at ingest, plus a monotonic version the session enforces
across ``ingest_append`` calls.
"""
from __future__ import annotations

import csv
import dataclasses
import os
from typing import Iterator, Protocol, runtime_checkable

import numpy as np

from repro_torch.core.partyblock import (CSVSource, DataSource, PartyBlock,
                                         csv_layout, parse_feature_rows,
                                         parse_labels)

DEFAULT_CHUNK_ROWS = 4096


@runtime_checkable
class ChunkedSource(Protocol):
    """Anything that can stream one party's extract as PartyBlock chunks.

    Every yielded chunk must agree on ``name``, feature layout
    (``n_features`` / ``feature_ids`` / ``feature_names``) and label
    presence; rows arrive in a stable order (two passes over the same
    source see the same rows in the same order — the scan pass and the
    bin pass both rely on it)."""

    def iter_chunks(self, rows: int) -> Iterator[PartyBlock]: ...


@dataclasses.dataclass
class ArraySource:
    """ChunkedSource over an in-memory PartyBlock — row-sliced views, no
    copies.  The adapter that lets blocks and true streams mix in one
    ingest, and the oracle-side twin in the bit-identity tests."""

    block: PartyBlock

    def iter_chunks(self, rows: int) -> Iterator[PartyBlock]:
        if rows < 1:
            raise ValueError(f"chunk rows must be >= 1, got {rows}")
        b = self.block
        if b.n_samples == 0:
            yield PartyBlock(name=b.name, x=b.x, ids=b.ids, y=b.y,
                             feature_ids=b.feature_ids,
                             feature_names=b.feature_names)
            return
        for lo in range(0, b.n_samples, rows):
            yield PartyBlock(
                name=b.name, x=b.x[lo:lo + rows], ids=b.ids[lo:lo + rows],
                y=None if b.y is None else b.y[lo:lo + rows],
                feature_ids=b.feature_ids, feature_names=b.feature_names)


@dataclasses.dataclass
class ChunkedCSVSource:
    """Stream a per-party CSV extract in bounded-row chunks.

    Same file format and parse rules as ``PartyBlock.from_csv`` (shared
    helpers), but the file is read incrementally: at no point is more than
    one chunk of raw feature values materialized.  The label dtype rule is
    applied per chunk; concatenation's dtype promotion makes the assembled
    column equal to the whole-file parse (int chunks promote to float64
    exactly when any chunk parses float-formatted labels).
    """

    path: str
    name: str | None = None
    id_column: str = "id"
    label_column: str = "label"
    delimiter: str = ","

    def iter_chunks(self, rows: int) -> Iterator[PartyBlock]:
        if rows < 1:
            raise ValueError(f"chunk rows must be >= 1, got {rows}")
        name = self.name \
            or os.path.splitext(os.path.basename(self.path))[0]
        with open(self.path, newline="") as fh:
            reader = csv.reader(fh, delimiter=self.delimiter)
            header = next(reader, None)
            if header is None:
                raise ValueError(f"{self.path}: empty CSV")
            id_idx, label_idx, feat_idx, names, feature_ids = csv_layout(
                header, self.path, id_column=self.id_column,
                label_column=self.label_column)
            offset, yielded = 0, False
            while True:
                body = []
                for r in reader:
                    body.append(r)
                    if len(body) >= rows:
                        break
                if not body and yielded:
                    return
                ids = np.array([r[id_idx] for r in body]) if body \
                    else np.empty(0, dtype="U1")
                x = parse_feature_rows(body, feat_idx, header, self.path,
                                       row_offset=offset)
                y = parse_labels([r[label_idx] for r in body]) \
                    if label_idx is not None else None
                yield PartyBlock(name=name, x=x, ids=ids, y=y,
                                 feature_ids=feature_ids,
                                 feature_names=names)
                offset += len(body)
                yielded = True
                if len(body) < rows:
                    return


def _require_pyarrow():
    """Lazy optional import: parquet reading needs pyarrow, everything
    else in the streaming plane must keep working without it."""
    try:
        import pyarrow.parquet as pq
    except ImportError as e:
        raise ImportError(
            "ChunkedParquetSource needs the optional 'pyarrow' package "
            "(pip install pyarrow); CSV and in-memory sources work "
            "without it") from e
    return pq


@dataclasses.dataclass
class ChunkedParquetSource:
    """Stream a per-party parquet extract in bounded-row chunks.

    Column semantics mirror :class:`ChunkedCSVSource` — the schema's column
    names go through the same ``csv_layout`` header rules (``id_column``
    names the sample-ID column, ``label_column`` the optional labels,
    every other column is a feature; ``gf<N>`` names carry explicit global
    feature ids).  Feature columns are read as float64, IDs keep their
    native kind (integer columns stay integers, anything else becomes
    strings — the same contract ``ProductSchema.id_kind`` speaks).

    Requires the optional ``pyarrow`` dependency; the import is deferred to
    ``iter_chunks`` so merely constructing (or pickling) the source works
    without it.  The party-per-process substrate ships no Parquet source to
    its workers (a ``TypeError``, as in the JAX package): stream it in
    process.
    """

    path: str
    name: str | None = None
    id_column: str = "id"
    label_column: str = "label"

    def iter_chunks(self, rows: int) -> Iterator[PartyBlock]:
        if rows < 1:
            raise ValueError(f"chunk rows must be >= 1, got {rows}")
        pq = _require_pyarrow()
        name = self.name \
            or os.path.splitext(os.path.basename(self.path))[0]
        pf = pq.ParquetFile(self.path)
        layout = csv_layout(list(pf.schema_arrow.names), self.path,
                            id_column=self.id_column,
                            label_column=self.label_column)
        yielded = False
        for batch in pf.iter_batches(batch_size=rows):
            yield self._chunk_of(batch, name, *layout)
            yielded = True
        if not yielded:
            # zero-row file: one empty chunk, like the CSV source, so the
            # scan pass still learns the party's shape
            yield self._chunk_of(pf.schema_arrow.empty_table(), name, *layout)

    @staticmethod
    def _chunk_of(batch, name, id_idx, label_idx, feat_idx, names,
                  feature_ids) -> PartyBlock:
        cols = [np.asarray(batch.column(j)) for j in range(batch.num_columns)]
        n = cols[0].shape[0] if cols else 0
        x = (np.column_stack([cols[j].astype(np.float64)
                              for j in feat_idx]) if n
             else np.empty((0, len(feat_idx)), dtype=np.float64))
        ids = cols[id_idx]
        if ids.dtype.kind not in "iu":
            ids = ids.astype(str)
        y = None
        if label_idx is not None:
            y = cols[label_idx]
            if y.dtype.kind not in "iuf":
                y = parse_labels([str(v) for v in y])
        return PartyBlock(name=name, x=x, ids=ids, y=y,
                          feature_ids=feature_ids, feature_names=names)


@dataclasses.dataclass(frozen=True)
class ProductSchema:
    """A data product's declared contract, validated against every chunk.

    Attributes:
      n_features: feature count every chunk must carry.
      feature_ids: the global column ids (None: contiguous assignment at
        ingest) — chunks must declare exactly these.
      feature_dtype: numpy dtype name the raw feature chunks must arrive
        as (``PartyBlock`` preserves float dtypes, promotes the rest to
        float64).
      id_kind: the ID contract — "str" or "int" sample keys.
      has_labels: whether this party publishes the labels.
    """

    n_features: int
    feature_ids: tuple[int, ...] | None = None
    feature_dtype: str = "float64"
    id_kind: str = "str"
    has_labels: bool = False

    def __post_init__(self):
        if self.id_kind not in ("str", "int"):
            raise ValueError(f"id_kind must be 'str' or 'int', got "
                             f"{self.id_kind!r}")
        np.dtype(self.feature_dtype)   # loud on an undeclarable dtype

    @classmethod
    def of(cls, block: PartyBlock) -> "ProductSchema":
        """Infer the schema a block already satisfies (test convenience)."""
        return cls(
            n_features=block.n_features,
            feature_ids=(tuple(int(f) for f in block.feature_ids)
                         if block.feature_ids is not None else None),
            feature_dtype=block.x.dtype.name,
            id_kind="int" if block.ids.dtype.kind in "iu" else "str",
            has_labels=block.y is not None)


@dataclasses.dataclass
class DataProduct:
    """A versioned party extract: source + declared schema + monotonic
    version (the data-mesh unit of exchange).

    Itself a :class:`ChunkedSource` — iteration re-yields the inner
    source's chunks after validating each against the schema, so a
    contract break surfaces at the first offending chunk with the product
    name, version, and the mismatch spelled out.  The session enforces
    version monotonicity across ``ingest_append`` calls.
    """

    name: str
    source: ChunkedSource
    schema: ProductSchema
    version: int = 1

    def __post_init__(self):
        if int(self.version) < 0:
            raise ValueError(f"product {self.name!r}: version must be >= 0, "
                             f"got {self.version}")

    def iter_chunks(self, rows: int) -> Iterator[PartyBlock]:
        for chunk in as_chunked(self.source).iter_chunks(rows):
            self._validate(chunk)
            yield chunk

    def _validate(self, chunk: PartyBlock) -> None:
        s, tag = self.schema, f"product {self.name!r} v{self.version}"
        if chunk.name != self.name:
            raise ValueError(f"{tag}: source yields chunks named "
                             f"{chunk.name!r} — a product's chunks must "
                             f"carry the product name")
        if chunk.n_features != s.n_features:
            raise ValueError(f"{tag}: declared {s.n_features} features but "
                             f"a chunk carries {chunk.n_features}")
        declared = None if s.feature_ids is None \
            else np.asarray(s.feature_ids, dtype=np.int64)
        got = chunk.feature_ids
        if (declared is None) != (got is None) \
                or (declared is not None
                    and not np.array_equal(declared, got)):
            raise ValueError(
                f"{tag}: declared feature_ids "
                f"{None if declared is None else declared.tolist()} but a "
                f"chunk carries "
                f"{None if got is None else got.tolist()}")
        if chunk.x.dtype != np.dtype(s.feature_dtype):
            raise ValueError(f"{tag}: declared feature dtype "
                             f"{s.feature_dtype!r} but a chunk arrived as "
                             f"{chunk.x.dtype.name!r}")
        kind = "int" if chunk.ids.dtype.kind in "iu" else "str"
        if chunk.ids.size and kind != s.id_kind:
            raise ValueError(f"{tag}: ID contract is {s.id_kind!r} keys but "
                             f"a chunk's ids are {chunk.ids.dtype} "
                             f"({kind!r})")
        if (chunk.y is not None) != s.has_labels:
            raise ValueError(
                f"{tag}: schema says has_labels={s.has_labels} but a chunk "
                f"{'carries' if chunk.y is not None else 'is missing'} "
                f"labels")


def as_chunked(source) -> ChunkedSource:
    """Normalize any party input into a ChunkedSource: chunked sources pass
    through, a whole-file CSVSource re-opens as its chunked twin, blocks
    and block-loading DataSources wrap in :class:`ArraySource`."""
    if hasattr(source, "iter_chunks"):
        return source
    if isinstance(source, CSVSource):
        return ChunkedCSVSource(
            path=source.path, name=source.name,
            id_column=source.id_column, label_column=source.label_column,
            delimiter=source.delimiter)
    if isinstance(source, PartyBlock):
        return ArraySource(source)
    if isinstance(source, DataSource):
        return ArraySource(source.load())
    raise TypeError(f"cannot stream a {type(source).__name__}: expected a "
                    f"ChunkedSource, PartyBlock, CSVSource or DataSource")


def is_chunked_sequence(data) -> bool:
    """True when ``data`` is a non-empty sequence containing at least one
    true chunked source (everything else adaptable) — the dispatch test
    behind Federation.ingest's streaming path."""
    if not isinstance(data, (list, tuple)) or not data:
        return False
    ok = (PartyBlock, DataSource)
    if not all(hasattr(b, "iter_chunks") or isinstance(b, ok) for b in data):
        return False
    return any(hasattr(b, "iter_chunks") for b in data)
