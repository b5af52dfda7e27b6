"""Streaming ingest engine: out-of-core alignment + binning + assembly.

The in-memory path (core/party.py: ``partition_from_blocks``) materializes
every party's raw block, aligns on hashed IDs, and bins each aligned block in
one ``np.quantile`` pass.  This engine produces the **same**
``VerticalPartition`` without ever holding a party's raw features densely:

  pass 1 (scan)   every chunk is hashed (IDs) and fed into per-feature
                  :class:`~repro_torch.streaming.sketch.FeatureSketches`;
                  only IDs, hashes, labels, and the sketches are retained —
                  all O(rows) metadata or O(capacity) sketch state, never
                  the (rows x features) raw block.
  align           the retained hashed IDs go through the exact in-memory
                  alignment contract: per-party duplicate rejection, the
                  pre-aligned raw-ID fast path (caller row order preserved
                  bit-for-bit), else ``crypto.align_ids`` onto the canonical
                  sorted-hash common ordering, loud on empty intersections.
  pass 2 (bin)    per party: bin edges come from the sketch (exact — hence
                  bit-identical to ``np.quantile`` — while it never
                  compacted; within the tracked rank-error bound after);
                  if alignment dropped rows, a re-sketch pass over the kept
                  rows runs first, because the in-memory build bins aligned
                  rows only.  Each chunk is then binned independently
                  (``binning.apply_bins`` is row-separable) and scattered
                  into the stacked (M, N, Fp) partition at its aligned
                  positions.

Bit-identity holds end to end while every party's sketch stays exact: the
streamed, chunked, out-of-order build equals the in-memory build on the same
rows, partition and fitted forest both.

:class:`PartyStream` is one party's append-extensible source list — the unit
the session keeps between ``ingest`` and ``ingest_append`` and the state a
distributed party worker holds process-side (only hashes, binned values and
labels ever cross the wire; sketches and raw chunks stay with the party).
Host-side NumPy, the same engine as the JAX package's
``repro.streaming.ingest``, with the same egress tags on the retained raw
arrays and the same counters and trace events.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.analysis import runtime as egress_runtime
from repro_torch.core import binning, crypto
from repro_torch.core.party import VerticalPartition, _pad_groups
from repro_torch.core.partyblock import feature_groups
from repro_torch.observability import registry as telemetry
from repro_torch.observability import trace as tracing
from repro_torch.streaming.sketch import DEFAULT_CAPACITY, FeatureSketches
from repro_torch.streaming.sources import DEFAULT_CHUNK_ROWS, as_chunked


@dataclasses.dataclass
class SourceScan:
    """What the scan pass retains of one source: everything downstream
    passes need *except* the raw feature values."""

    name: str
    n_rows: int
    ids: np.ndarray                  # raw sample IDs, stream order
    hashes: np.ndarray               # salted hashes of the same
    sketches: FeatureSketches        # full-stream per-feature sketches
    y: np.ndarray | None
    feature_ids: np.ndarray | None
    feature_names: tuple[str, ...] | None
    version: int | None = None       # DataProduct version, if any

    def __post_init__(self) -> None:
        # tag the retained raw arrays for the runtime egress guard (no-op
        # unless REPRO_EGRESS_GUARD=1); `hashes` is wire-safe by policy
        egress_runtime.taint(
            self.ids, f"SourceScan[{self.name!r}].ids (raw sample IDs)")
        if self.y is not None:
            egress_runtime.taint(
                self.y, f"SourceScan[{self.name!r}].y (raw labels)")


def scan_source(source, *, chunk_rows: int = DEFAULT_CHUNK_ROWS,
                capacity: int = DEFAULT_CAPACITY,
                salt: str = crypto.DEFAULT_SALT) -> SourceScan:
    """Pass 1 over one source: hash IDs, sketch features, retain labels.
    Validates that every chunk agrees on the party's shape (name, feature
    layout, label presence) and raises loudly naming the chunk if not."""
    src = as_chunked(source)
    name = n_feat = fids = fnames = has_y = sk = None
    ids_parts, hash_parts, y_parts = [], [], []
    for k, chunk in enumerate(src.iter_chunks(chunk_rows)):
        if name is None:
            name, n_feat = chunk.name, chunk.n_features
            fids, fnames = chunk.feature_ids, chunk.feature_names
            has_y = chunk.y is not None
            sk = FeatureSketches(n_feat, capacity)
        else:
            if chunk.name != name:
                raise ValueError(f"source for party {name!r}: chunk {k} is "
                                 f"named {chunk.name!r} — one source, one "
                                 f"party")
            if chunk.n_features != n_feat:
                raise ValueError(f"party {name!r}: chunk {k} carries "
                                 f"{chunk.n_features} features, previous "
                                 f"chunks carried {n_feat}")
            if (fids is None) != (chunk.feature_ids is None) or (
                    fids is not None
                    and not np.array_equal(fids, chunk.feature_ids)):
                raise ValueError(f"party {name!r}: chunk {k} changes "
                                 f"feature_ids mid-stream")
            if (chunk.y is not None) != has_y:
                raise ValueError(f"party {name!r}: chunk {k} "
                                 f"{'grew' if chunk.y is not None else 'lost'}"
                                 f" labels mid-stream — label presence must "
                                 f"be uniform across chunks")
        sk.update(chunk.x)
        ids_parts.append(chunk.ids)
        hash_parts.append(crypto.hash_ids(chunk.ids, salt=salt))
        if has_y:
            y_parts.append(chunk.y)
        telemetry.REGISTRY.counter("streaming.chunks_scanned").inc()
        telemetry.REGISTRY.counter("streaming.rows_scanned").inc(
            int(chunk.n_samples))
    if name is None:
        raise ValueError(f"{source!r}: source yielded no chunks")
    tracing.TRACER.event("stream.scan", category="host", party=name,
                         rows=sum(int(a.size) for a in ids_parts))
    return SourceScan(
        name=name, n_rows=sum(int(a.size) for a in ids_parts),
        ids=_concat(ids_parts), hashes=_concat(hash_parts),
        sketches=sk, y=_concat(y_parts) if has_y else None,
        feature_ids=fids, feature_names=fnames,
        version=getattr(source, "version", None))


def _concat(parts: list[np.ndarray]) -> np.ndarray:
    """Concatenate, ignoring empty arrays so their placeholder dtypes can't
    poison the promotion (an empty '<U1' chunk must not stringify int IDs);
    all-empty falls back to the first part."""
    filled = [a for a in parts if a.size]
    return np.concatenate(filled) if filled \
        else np.asarray(parts[0]).reshape(-1)


class PartyStream:
    """One party's append-extensible chunked data feed + its scan state.

    ``extend`` lands a new source (an ``ingest_append``): the source is
    scanned once, validated against the party's established shape and the
    product-version contract (versions must strictly increase), and its scan
    cached — re-assembly after an append re-reads raw chunks (bin edges move
    when rows land, so old rows re-bin) but never re-hashes or re-sketches
    what was already scanned.
    """

    def __init__(self, *, chunk_rows: int = DEFAULT_CHUNK_ROWS,
                 capacity: int = DEFAULT_CAPACITY,
                 salt: str = crypto.DEFAULT_SALT):
        self.chunk_rows = int(chunk_rows)
        self.capacity = int(capacity)
        self.salt = salt
        self.sources: list = []
        self.scans: list[SourceScan] = []
        self._merged: SourceScan | None = None

    @property
    def name(self) -> str:
        if not self.scans:
            raise ValueError("empty PartyStream has no name yet")
        return self.scans[0].name

    @property
    def version(self) -> int | None:
        """The latest product version landed (None: unversioned sources)."""
        for s in reversed(self.scans):
            if s.version is not None:
                return int(s.version)
        return None

    def extend(self, source) -> SourceScan:
        scan = scan_source(source, chunk_rows=self.chunk_rows,
                           capacity=self.capacity, salt=self.salt)
        _extend_with_scan(self, source, scan)
        return scan

    def merged_scan(self) -> SourceScan:
        """The party's scans fused into one (cached until the next extend).
        Sketch merges and array concatenation only — no chunk re-reads."""
        if self._merged is not None:
            return self._merged
        if not self.scans:
            raise ValueError("empty PartyStream: extend() a source first")
        if len(self.scans) == 1:
            self._merged = self.scans[0]
            return self._merged
        head = self.scans[0]
        sk = head.sketches
        for s in self.scans[1:]:
            sk = sk.merge(s.sketches)
        self._merged = SourceScan(
            name=head.name,
            n_rows=sum(s.n_rows for s in self.scans),
            ids=_concat([s.ids for s in self.scans]),
            hashes=_concat([s.hashes for s in self.scans]),
            sketches=sk,
            y=_concat([s.y for s in self.scans])
            if head.y is not None else None,
            feature_ids=head.feature_ids,
            feature_names=head.feature_names,
            version=self.version)
        return self._merged

    def iter_chunks(self):
        """Raw chunks across all landed sources, scan order (pass 2)."""
        for src in self.sources:
            yield from src.iter_chunks(self.chunk_rows)


def party_stream_bin(stream: PartyStream, positions, n_bins: int):
    """Pass 2 for one party: derive bin edges from the sketch and bin every
    chunk into the aligned row order.  Returns ``(xb_i, boundaries_i, y_i)``
    with ``xb_i`` (n_common, F_i) uint8 in ascending-global-id column order,
    ``boundaries_i`` (F_i, n_bins - 1), and the aligned labels (or None).

    This is the party-side half of streamed ingest — the distributed worker
    runs exactly this function process-side, so only its return values ever
    cross the wire.

    When alignment kept every row (``positions`` is a permutation), the
    scan-pass sketch is already the sketch of the aligned rows (same
    multiset), so no second read of the raw data happens.  Otherwise the
    kept rows are re-sketched first: the in-memory build derives edges from
    aligned rows only, and bit-identity is the contract.
    """
    s = stream.merged_scan()
    pos = np.asarray(positions, dtype=np.int64)
    col_order = np.argsort(s.feature_ids) if s.feature_ids is not None \
        else None
    sk = s.sketches
    if pos.size != s.n_rows:
        keep = np.zeros(s.n_rows, dtype=bool)
        keep[pos] = True
        sk = FeatureSketches(s.sketches.n_features, stream.capacity)
        off = 0
        for chunk in stream.iter_chunks():
            sk.update(chunk.x[keep[off:off + chunk.n_samples]])
            off += chunk.n_samples
    edges = sk.edges(n_bins)                       # original column order
    if col_order is not None:
        edges = edges[col_order]                   # ascending global id
    out_pos = np.full(s.n_rows, -1, dtype=np.int64)
    out_pos[pos] = np.arange(pos.size, dtype=np.int64)
    xb_i = np.zeros((pos.size, s.sketches.n_features), dtype=np.uint8)
    off = 0
    for chunk in stream.iter_chunks():
        sel = out_pos[off:off + chunk.n_samples]
        kept = sel >= 0
        if kept.any():
            x_c = chunk.x[kept]
            if col_order is not None:
                x_c = x_c[:, col_order]
            xb_i[sel[kept]] = binning.apply_bins(x_c, edges)
        off += chunk.n_samples
    y_i = s.y[pos] if s.y is not None else None
    telemetry.REGISTRY.counter("streaming.rows_binned").inc(int(pos.size))
    tracing.TRACER.event("stream.bin", category="host", party=s.name,
                         rows=int(pos.size))
    return xb_i, edges, y_i


def align_streams(streams: list[PartyStream]):
    """The alignment step over scanned streams — decision for decision the
    in-memory ``align_party_blocks`` contract (duplicate rejection naming
    the party, raw-ID fast path preserving caller row order, canonical
    sorted-hash ordering otherwise, loud empty-intersection errors).

    Returns ``(common_ids, positions)`` like align_party_blocks."""
    scans = [st.merged_scan() for st in streams]
    names = [s.name for s in scans]
    for s in scans:
        if np.unique(s.ids).size != s.ids.size:
            raise ValueError(
                f"party {s.name!r} has duplicate sample IDs: alignment "
                f"would be ambiguous — deduplicate before ingest")
    first = scans[0].ids
    if all(s.ids.shape == first.shape and np.array_equal(s.ids, first)
           for s in scans[1:]):
        if first.size == 0:
            raise ValueError(
                f"empty hashed-ID intersection across parties "
                f"{names}: no shared samples to align")
        pos = np.arange(len(first), dtype=np.int64)
        return first.copy(), [pos.copy() for _ in scans]
    positions, _ = crypto.align_hashed(
        [s.hashes for s in scans], names,
        check_unique=False, identity_fast_path=False)
    return scans[0].ids[positions[0]], positions


def assemble_streams(streams: list[PartyStream], n_bins: int):
    """Align scanned party streams and assemble the stacked partition
    (pass 2 per party).  Returns ``(partition, y, common_ids)`` exactly like
    ``partition_from_blocks`` — except ``raw_parts`` is None, because no
    dense raw block ever existed."""
    streams = sorted(streams, key=lambda st: st.name)   # canonical order
    names = [st.name for st in streams]
    if len(set(names)) != len(names):
        raise ValueError(f"party names must be unique, got {names}")
    common_ids, positions = align_streams(streams)
    scans = [st.merged_scan() for st in streams]
    groups, n_features = feature_groups(
        [s.feature_ids for s in scans],
        [s.sketches.n_features for s in scans])
    feat_gid = _pad_groups(groups)
    m, fp = feat_gid.shape
    xb = np.zeros((m, len(common_ids), fp), dtype=np.uint8)
    boundaries = np.zeros((n_features, max(n_bins - 1, 0)), dtype=np.float64)
    y, holder = None, None
    for i, (st, pos, g) in enumerate(zip(streams, positions, groups)):
        xb_i, edges_i, y_i = party_stream_bin(st, pos, n_bins)
        xb[i, :, : xb_i.shape[1]] = xb_i
        boundaries[g] = edges_i
        if y_i is not None:
            if holder is not None:
                raise ValueError(
                    f"labels held by more than one party ({holder!r} and "
                    f"{names[i]!r}); exactly one party owns the labels")
            holder, y = names[i], y_i
    part = VerticalPartition(xb=xb, feat_gid=feat_gid,
                             n_features=n_features, boundaries=boundaries,
                             raw_parts=None, party_names=tuple(names))
    return part, y, common_ids


def open_streams(sources, *, chunk_rows: int = DEFAULT_CHUNK_ROWS,
                 capacity: int = DEFAULT_CAPACITY,
                 salt: str = crypto.DEFAULT_SALT) -> list[PartyStream]:
    """Scan one source per party into fresh PartyStreams (pass 1)."""
    streams = []
    for src in sources:
        st = PartyStream(chunk_rows=chunk_rows, capacity=capacity, salt=salt)
        st.extend(src)
        streams.append(st)
    names = [st.name for st in streams]
    if len(set(names)) != len(names):
        raise ValueError(f"party names must be unique, got {names}")
    return streams


def append_streams(streams: list[PartyStream], sources) -> None:
    """Land appended sources onto existing streams, matched by the party
    name each source's chunks carry.  Any subset of parties may publish new
    rows; rows only join the training set once every party has them (the
    intersection semantics of alignment do the bookkeeping)."""
    by_name = {st.name: st for st in streams}
    for src in sources:
        scan = scan_source(src, chunk_rows=streams[0].chunk_rows,
                           capacity=streams[0].capacity,
                           salt=streams[0].salt)
        st = by_name.get(scan.name)
        if st is None:
            raise ValueError(
                f"ingest_append: source names party {scan.name!r} but the "
                f"session ingested parties {sorted(by_name)} — appends "
                f"extend existing parties, they cannot add new ones")
        # hand the already-computed scan to the stream: re-scanning would
        # double the pass-1 IO, so extend() is bypassed in favor of its
        # validations on the cached scan
        _extend_with_scan(st, src, scan)


def _extend_with_scan(st: PartyStream, source, scan: SourceScan) -> None:
    """PartyStream.extend's validations + landing, for a pre-computed scan."""
    if not st.scans:
        st.sources.append(as_chunked(source))
        st.scans.append(scan)
        st._merged = None
        return
    head = st.scans[0]
    if scan.name != head.name:
        raise ValueError(f"cannot append source named {scan.name!r} "
                         f"to party {head.name!r}")
    if scan.sketches.n_features != head.sketches.n_features:
        raise ValueError(
            f"party {head.name!r}: appended source carries "
            f"{scan.sketches.n_features} features, the stream carries "
            f"{head.sketches.n_features}")
    if (head.feature_ids is None) != (scan.feature_ids is None) or (
            head.feature_ids is not None and not np.array_equal(
                head.feature_ids, scan.feature_ids)):
        raise ValueError(f"party {head.name!r}: appended source changes "
                         f"feature_ids")
    if (scan.y is not None) != (head.y is not None):
        raise ValueError(
            f"party {head.name!r}: the label holder must append labelled "
            f"rows and label-free parties label-free rows")
    prev = st.version
    if prev is not None and (scan.version is None
                             or int(scan.version) <= prev):
        raise ValueError(
            f"party {head.name!r}: appended product version {scan.version!r} "
            f"does not advance v{prev} — product versions are monotonic "
            f"(re-publishing an old extract would silently double-ingest "
            f"its rows)")
    st.sources.append(as_chunked(source))
    st.scans.append(scan)
    st._merged = None


def streaming_ingest(sources, n_bins: int, *,
                     chunk_rows: int = DEFAULT_CHUNK_ROWS,
                     capacity: int = DEFAULT_CAPACITY,
                     salt: str = crypto.DEFAULT_SALT,
                     validate: bool = False):
    """One-call streamed ingest: scan, align, assemble.

    Returns ``(partition, y, common_ids, streams)``; keep ``streams`` to
    land appends later (``append_streams`` + ``assemble_streams``).
    """
    if validate:
        raise ValueError(
            "validate=True re-bins the assembled central matrix, which a "
            "streamed build never holds — validate an in-memory ingest of "
            "the same rows instead (the bit-identity tests do exactly that)")
    streams = open_streams(sources, chunk_rows=chunk_rows,
                           capacity=capacity, salt=salt)
    part, y, common = assemble_streams(streams, n_bins)
    return part, y, common, streams
