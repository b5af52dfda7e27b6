"""Party-first data plane: per-party raw blocks keyed by sample IDs.

The paper's system (§3.1, §4.3) starts where each region actually stands:
every party holds its own feature block over its own customer base, keyed by
sample IDs, and training begins with encrypted-ID alignment.  A
:class:`PartyBlock` is that unit of ingestion — raw features + sample IDs +
(for exactly one party) the labels — and :class:`DataSource` is the hook for
loading one from a per-party file (``CSVSource``).

Alignment (:func:`align_party_blocks`) intersects the parties' *hashed* IDs
(crypto.align_ids, the PSI stand-in) and gathers every block onto one
canonical common ordering: the lexicographic sort of the common hashed IDs.
That ordering is invariant to each party's row order and to party order, so
shuffled, superset, out-of-order regional extracts all collapse to the same
aligned sample matrix — which is what makes federated fits from PartyBlocks
bit-identical to the centrally pre-aligned build.  Host-side NumPy, the same
code as the JAX package's, so both packages align and parse identically.

Partition assembly (party-local quantile binning + the stacked
VerticalPartition) lives in core/party.py: ``partition_from_blocks``.
"""
from __future__ import annotations

import csv
import dataclasses
import os
from typing import Protocol, runtime_checkable

import numpy as np

from repro_torch.analysis import runtime as egress_runtime
from repro_torch.core import crypto


@dataclasses.dataclass
class PartyBlock:
    """One party's raw contribution to a federated dataset.

    Attributes:
      name: stable party identifier.  Ingestion orders parties by name
        (canonical party ordering), and serving matches request blocks to
        fit-time parties by it.
      x: (n_i, f_i) float raw feature block — never leaves the party; only
        binned values and masked statistics ever would.
      ids: (n_i,) sample IDs (ints or strings).  Alignment happens on their
        salted hashes; duplicates within a party are rejected.
      y: optional (n_i,) party-held labels, row-aligned with ``ids``.
        Exactly one party of a federation may hold labels.
      feature_ids: optional (f_i,) global column ids.  When set across all
        parties they must partition 0..F-1 (the raw-matrix compat adapter
        uses this to preserve the original column encoding); when omitted,
        ingestion assigns contiguous ids in canonical party order.
      feature_names: optional (f_i,) display names (CSV headers keep them).
    """

    name: str
    x: np.ndarray
    ids: np.ndarray
    y: np.ndarray | None = None
    feature_ids: np.ndarray | None = None
    feature_names: tuple[str, ...] | None = None

    def __post_init__(self) -> None:
        # keep float inputs at their own precision (binning casts to float64
        # internally either way, so losslessness is unaffected; coercing
        # float32 silos would double their memory), promote everything else
        self.x = np.asarray(self.x)
        if not np.issubdtype(self.x.dtype, np.floating):
            self.x = self.x.astype(np.float64)
        self.ids = np.asarray(self.ids).reshape(-1)
        if self.x.ndim != 2:
            raise ValueError(f"party {self.name!r}: x must be (n_samples, "
                             f"n_features), got shape {self.x.shape}")
        if len(self.ids) != self.x.shape[0]:
            raise ValueError(
                f"party {self.name!r}: {len(self.ids)} sample IDs for "
                f"{self.x.shape[0]} feature rows")
        if self.y is not None:
            self.y = np.asarray(self.y).reshape(-1)
            if len(self.y) != self.x.shape[0]:
                raise ValueError(
                    f"party {self.name!r}: {len(self.y)} labels for "
                    f"{self.x.shape[0]} rows")
        if self.feature_ids is not None:
            self.feature_ids = np.asarray(self.feature_ids,
                                          dtype=np.int64).reshape(-1)
            if len(self.feature_ids) != self.x.shape[1]:
                raise ValueError(
                    f"party {self.name!r}: {len(self.feature_ids)} "
                    f"feature_ids for {self.x.shape[1]} columns")
        # tag the final raw arrays for the runtime egress guard (no-op
        # unless REPRO_EGRESS_GUARD=1): these buffers and their views —
        # tensors over them included — must never reach Channel.send
        # unsanitized
        egress_runtime.taint_block(self)

    @property
    def n_samples(self) -> int:
        return int(self.x.shape[0])

    @property
    def n_features(self) -> int:
        return int(self.x.shape[1])

    def hashed_ids(self, salt: str = crypto.DEFAULT_SALT) -> np.ndarray:
        return crypto.hash_ids(self.ids, salt=salt)

    # ----------------------------------------------------------------- CSV
    @classmethod
    def from_csv(cls, path: str, *, name: str | None = None,
                 id_column: str = "id", label_column: str = "label",
                 delimiter: str = ",") -> "PartyBlock":
        """Load a per-party CSV extract: a header row names the columns,
        ``id_column`` keys the rows, ``label_column`` (if present in the
        header) becomes the party-held labels, every other column is a float
        feature.  ``name`` defaults to the file stem.  Feature headers of
        the form ``gf<N>`` (to_csv's encoding of global feature ids) are
        parsed back into ``feature_ids``, so the to_csv round trip preserves
        the global column encoding.

        Missing or NaN feature cells raise a loud ValueError naming the
        column and row — binning would otherwise silently sort NaNs into the
        last bin and corrupt every split on that feature."""
        with open(path, newline="") as fh:
            rows = list(csv.reader(fh, delimiter=delimiter))
        if not rows:
            raise ValueError(f"{path}: empty CSV")
        header, body = rows[0], rows[1:]
        id_idx, label_idx, feat_idx, names, feature_ids = csv_layout(
            header, path, id_column=id_column, label_column=label_column)
        ids = np.array([r[id_idx] for r in body])
        x = parse_feature_rows(body, feat_idx, header, path)
        y = parse_labels([r[label_idx] for r in body]) \
            if label_idx is not None else None
        return cls(name=name or os.path.splitext(os.path.basename(path))[0],
                   x=x, ids=ids, y=y, feature_ids=feature_ids,
                   feature_names=names)

    def to_csv(self, path: str, *, id_column: str = "id",
               label_column: str = "label") -> str:
        """Write the block as a per-party CSV (the from_csv inverse).

        Global feature ids, when present, are load-bearing for the column
        encoding, so they win over ``feature_names`` as headers: each
        column is written as ``gf<global id>`` and from_csv parses that
        back — a round trip cannot silently reassign the encoding."""
        if self.feature_ids is not None:
            names = tuple(f"gf{j}" for j in self.feature_ids)
        else:
            names = self.feature_names or tuple(
                f"f{j}" for j in range(self.n_features))
        with open(path, "w", newline="") as fh:
            w = csv.writer(fh)
            w.writerow([id_column, *names]
                       + ([label_column] if self.y is not None else []))
            for i in range(self.n_samples):
                row = [self.ids[i], *(repr(float(v)) for v in self.x[i])]
                if self.y is not None:
                    row.append(self.y[i])
                w.writerow(row)
        return path


# -------------------------------------------------------- CSV parse helpers
# Shared by PartyBlock.from_csv and the streaming ChunkedCSVSource: one owner
# of the header layout, the float parse (with the loud NaN/missing contract),
# and the label dtype rule, so a chunked read is bit-identical to from_csv.

def csv_layout(header: list[str], path: str, *, id_column: str = "id",
               label_column: str = "label"):
    """Resolve a CSV header into ``(id_idx, label_idx, feat_idx, names,
    feature_ids)``.  ``label_idx`` is None when no label column is present;
    ``feature_ids`` is parsed from all-``gf<N>`` headers (to_csv's global-id
    encoding) or None."""
    if id_column not in header:
        raise ValueError(f"{path}: no {id_column!r} column in header "
                         f"{header}")
    id_idx = header.index(id_column)
    label_idx = header.index(label_column) if label_column in header else None
    feat_idx = [j for j in range(len(header)) if j not in (id_idx, label_idx)]
    names = tuple(header[j] for j in feat_idx)
    feature_ids = None
    if names and all(n.startswith("gf") and n[2:].isdigit() for n in names):
        feature_ids = np.array([int(n[2:]) for n in names])
    return id_idx, label_idx, feat_idx, names, feature_ids


def parse_feature_rows(body, feat_idx, header, path: str, *,
                       row_offset: int = 0) -> np.ndarray:
    """Parse CSV body rows into a float64 feature matrix, raising a loud
    ValueError naming the column and (global) row index on missing or NaN
    cells instead of letting NaNs reach binning."""
    x = np.empty((len(body), len(feat_idx)), dtype=np.float64)
    for i, r in enumerate(body):
        for k, j in enumerate(feat_idx):
            cell = r[j].strip() if j < len(r) else ""
            v = float(cell) if cell else float("nan")
            if v != v:  # NaN — explicit "nan" cells and missing cells alike
                raise ValueError(
                    f"{path}: missing/NaN value in feature column "
                    f"{header[j]!r} at data row {row_offset + i} — clean or "
                    f"impute before ingest (binning would silently bucket "
                    f"NaNs and corrupt every split on that feature)")
            x[i, k] = v
    return x


def parse_labels(vals: list[str]) -> np.ndarray:
    """The label dtype rule: lexically-integer labels ("3") are class ids
    (int64); anything float-formatted ("3.0") stays float, so to_csv round
    trips regression targets that happen to be whole numbers without a dtype
    change."""
    if vals and all(v.removeprefix("-").removeprefix("+").isdigit()
                    for v in vals):
        return np.array([int(v) for v in vals], dtype=np.int64)
    return np.array([float(v) for v in vals])


def feature_groups(feature_ids_per_party, n_features_per_party):
    """Resolve per-party global feature-id groups — the single owner of the
    all-or-none feature_ids contract shared by every ingest path (in-memory
    ``partition_from_blocks``, distributed workers, streaming assembly).

    When every party declares ``feature_ids`` they must partition 0..F-1
    (ascending within each party); when none do, contiguous ids are assigned
    in the given (canonical) party order.  Returns ``(groups, n_features)``.
    """
    with_ids = [f for f in feature_ids_per_party if f is not None]
    if with_ids and len(with_ids) != len(feature_ids_per_party):
        raise ValueError("feature_ids must be set on every party or none")
    if with_ids:
        groups = [np.sort(np.asarray(f, dtype=np.int64).reshape(-1))
                  for f in feature_ids_per_party]
        all_ids = np.concatenate(groups) if groups else np.empty(0, np.int64)
        n_features = int(all_ids.size)
        if not np.array_equal(np.sort(all_ids), np.arange(n_features)):
            raise ValueError(
                f"feature_ids across parties must partition 0..F-1, got "
                f"{sorted(all_ids.tolist())}")
    else:
        offsets = np.cumsum([0] + list(n_features_per_party))
        groups = [np.arange(offsets[i], offsets[i + 1])
                  for i in range(len(n_features_per_party))]
        n_features = int(offsets[-1])
    return groups, n_features


@runtime_checkable
class DataSource(Protocol):
    """Anything that can produce a PartyBlock — the per-party loading hook
    ``Federation.ingest`` accepts in place of a materialized block."""

    def load(self) -> PartyBlock: ...


@dataclasses.dataclass
class CSVSource:
    """DataSource for a per-party CSV file (see PartyBlock.from_csv)."""

    path: str
    name: str | None = None
    id_column: str = "id"
    label_column: str = "label"
    delimiter: str = ","

    def load(self) -> PartyBlock:
        return PartyBlock.from_csv(self.path, name=self.name,
                                   id_column=self.id_column,
                                   label_column=self.label_column,
                                   delimiter=self.delimiter)


def resolve_blocks(blocks) -> list[PartyBlock]:
    """Materialize a mixed PartyBlock / DataSource sequence."""
    out = []
    for b in blocks:
        if isinstance(b, PartyBlock):
            out.append(b)
        elif isinstance(b, DataSource):
            loaded = b.load()
            if not isinstance(loaded, PartyBlock):
                raise TypeError(f"DataSource {b!r} loaded "
                                f"{type(loaded).__name__}, not a PartyBlock")
            out.append(loaded)
        else:
            raise TypeError(f"expected PartyBlock or DataSource, got "
                            f"{type(b).__name__}")
    names = [b.name for b in out]
    if len(set(names)) != len(names):
        raise ValueError(f"party names must be unique, got {names}")
    return out


def is_block_sequence(data) -> bool:
    """True when ``data`` is a non-empty sequence of PartyBlock/DataSource —
    the dispatch test behind Federation.ingest's two entry shapes."""
    return (isinstance(data, (list, tuple)) and len(data) > 0
            and all(isinstance(b, (PartyBlock, DataSource)) for b in data))


def align_party_blocks(blocks: list[PartyBlock], *,
                       salt: str = crypto.DEFAULT_SALT):
    """Align M party blocks on their hashed sample IDs.

    Returns ``(common_ids, positions)``: the common *raw* IDs in canonical
    order (sorted by hashed value), and one int64 position array per block
    such that ``blocks[i].x[positions[i]]`` rows line up across parties.

    Pre-aligned blocks (every party lists the identical IDs in the identical
    order — the raw-matrix compat adapter) skip the hashing pass: the
    identity alignment is returned directly, preserving the caller's row
    order bit-for-bit.
    """
    for b in blocks:
        if np.unique(b.ids).size != b.ids.size:
            raise ValueError(
                f"party {b.name!r} has duplicate sample IDs: alignment "
                f"would be ambiguous — deduplicate before ingest")
    first = blocks[0].ids
    if all(b.ids.shape == first.shape and np.array_equal(b.ids, first)
           for b in blocks[1:]):
        if first.size == 0:     # the fast path must keep the loud-error
            raise ValueError(   # contract, not fall through to binning
                f"empty hashed-ID intersection across parties "
                f"{[b.name for b in blocks]}: no shared samples to align")
        pos = np.arange(len(first), dtype=np.int64)
        return first.copy(), [pos.copy() for _ in blocks]
    try:
        # uniqueness already validated above with party names attached
        positions = crypto.align_ids(*(b.hashed_ids(salt) for b in blocks),
                                     check_unique=False)
    except ValueError as e:
        if "intersection" not in str(e):
            raise
        raise ValueError(
            f"empty hashed-ID intersection across parties "
            f"{[b.name for b in blocks]}: no shared samples to align "
            f"(same ID space and salt on every party?)") from e
    return blocks[0].ids[positions[0]], list(positions)
