"""Vertical partitioning of a dataset across M regional parties.

Mirrors the paper's data distribution (§3.1): identical, pre-aligned sample
space; disjoint feature sets per party.  The partition is stored as
*stacked, padded* host arrays with a leading party axis; a fit moves them
to the device once.

Two roads lead here, host-side NumPy and bit-identical to the JAX
package's:
  * ``partition_from_blocks`` — the canonical party-first path: per-party
    PartyBlocks (core/partyblock.py) are aligned on hashed sample IDs and
    binned *party-locally*; quantile binning is a per-feature transform, so
    the result is bit-identical to binning the assembled central matrix
    (``validate=True`` asserts it).
  * ``make_vertical_partition`` — the raw-matrix compat adapter: a central
    (N, F) matrix is split into pre-aligned PartyBlocks and fed through the
    exact same assembly.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import binning, crypto
from repro_torch.core.partyblock import (PartyBlock, align_party_blocks,
                                         feature_groups, resolve_blocks)


@dataclasses.dataclass
class VerticalPartition:
    """Vertically partitioned, binned dataset.

    Attributes:
      xb:        (M, N, Fp) uint8 — party-local binned features, zero-padded.
      feat_gid:  (M, Fp) int32    — global (encoded) feature id, -1 for padding.
      n_parties: M.
      n_features: total real features F.
      boundaries: (F, n_bins-1) float64 — per-feature bin boundaries (kept by
                  the owning party only in a real deployment; stored centrally
                  here for test-time re-binning).
      raw_parts:  optional per-party raw (unbinned) feature blocks — what a
                  party actually holds locally.  Tree models only ever see
                  ``xb``.
      party_names: per-party identifiers in party-axis order (canonical:
                  sorted).  Serving matches per-party request blocks to
                  fit-time parties by name (``bin_party_blocks``).
    """

    xb: np.ndarray
    feat_gid: np.ndarray
    n_features: int
    boundaries: np.ndarray
    raw_parts: list[np.ndarray] | None = None
    party_names: tuple[str, ...] | None = None

    @property
    def n_parties(self) -> int:
        return int(self.xb.shape[0])

    @property
    def n_samples(self) -> int:
        return int(self.xb.shape[1])

    @property
    def n_bins(self) -> int:
        """Bin count this partition was quantized with (boundaries are the
        n_bins-1 inner edges)."""
        return int(self.boundaries.shape[1]) + 1

    def bin_test(self, x_test: np.ndarray) -> np.ndarray:
        """Bin a raw test matrix (N_t, F) and partition it like training data."""
        xb = binning.apply_bins(x_test, self.boundaries)
        return _partition_binned(xb, self.feat_gid)

    def split_raw(self, x: np.ndarray) -> list[np.ndarray]:
        """Split a raw (N, F) matrix into per-party column blocks, matching
        the feature assignment of this partition (no binning)."""
        x = np.asarray(x)
        return [x[:, self.feat_gid[i][self.feat_gid[i] >= 0]]
                for i in range(self.n_parties)]

    def dense_raw(self) -> np.ndarray:
        """The equivalent centrally pre-aligned raw (N, F) matrix — the
        parties' aligned blocks scattered back to global column positions
        (the inverse of split_raw; needs ``raw_parts``)."""
        if self.raw_parts is None:
            raise ValueError("this partition was built without raw_parts")
        out = np.empty((self.n_samples, self.n_features), dtype=np.float64)
        for i, rp in enumerate(self.raw_parts):
            out[:, self.feat_gid[i][self.feat_gid[i] >= 0]] = rp
        return out

    def party_index(self, name: str) -> int:
        if self.party_names is None:
            raise ValueError("partition carries no party names")
        if name not in self.party_names:
            raise ValueError(f"unknown party {name!r} (partition has "
                             f"{list(self.party_names)})")
        return self.party_names.index(name)

    def _match_blocks(self, blocks) -> list:
        """Resolve request blocks against this partition's parties: matched
        by name when the partition carries ``party_names`` (any input
        order), else they must arrive in party-axis order."""
        blocks = resolve_blocks(blocks)
        if self.party_names is not None:
            by_name = {b.name: b for b in blocks}
            missing = [n for n in self.party_names if n not in by_name]
            extra = [n for n in by_name if n not in self.party_names]
            if missing or extra:
                raise ValueError(
                    f"request blocks must cover exactly the fit-time "
                    f"parties {list(self.party_names)}; missing {missing}, "
                    f"unknown {extra}")
            return [by_name[n] for n in self.party_names]
        if len(blocks) != self.n_parties:
            raise ValueError(f"expected {self.n_parties} request blocks, "
                             f"got {len(blocks)}")
        return blocks

    def raw_party_rows(self, blocks, *, salt: str = crypto.DEFAULT_SALT):
        """Align per-party *request* blocks against this fit-time partition
        and return their raw rows: out-of-order and superset rows are
        re-aligned on hashed IDs (non-common rows dropped) and each block's
        columns are put in fit-time party-local order (``feature_ids``
        validated against the fit-time assignment when present).

        Returns ``(common_ids, raw_parts)`` — the canonical aligned IDs and
        one raw (n, F_i) block per party; tree models bin these rows
        (:meth:`bin_party_blocks`)."""
        blocks = self._match_blocks(blocks)
        common, positions = align_party_blocks(blocks, salt=salt)
        parts = []
        for i, (b, pos) in enumerate(zip(blocks, positions)):
            gid = self.feat_gid[i][self.feat_gid[i] >= 0]
            x_i = b.x[pos]
            if b.feature_ids is not None:       # request columns may arrive
                order = np.argsort(b.feature_ids)  # in any global-id order
                if not np.array_equal(b.feature_ids[order], gid):
                    raise ValueError(
                        f"party {b.name!r}: request feature_ids "
                        f"{sorted(b.feature_ids)} != fit-time features "
                        f"{list(gid)}")
                x_i = x_i[:, order]
            elif b.n_features != len(gid):
                raise ValueError(
                    f"party {b.name!r}: request block has {b.n_features} "
                    f"features but the fit-time partition holds {len(gid)}")
            parts.append(np.asarray(x_i))
        return common, parts

    def bin_party_blocks(self, blocks, *, salt: str = crypto.DEFAULT_SALT):
        """Align + bin per-party *request* blocks against this fit-time
        partition: the rows from :meth:`raw_party_rows`, binned party-locally
        with each feature's fit-time boundaries and stacked into the
        (M, n, Fp) request tensor the one-round predict consumes.

        Returns ``(common_ids, xb_parts)``.
        """
        common, parts = self.raw_party_rows(blocks, salt=salt)
        m, fp = self.feat_gid.shape
        out = np.zeros((m, len(common), fp), dtype=np.uint8)
        for i, x_i in enumerate(parts):
            gid = self.feat_gid[i][self.feat_gid[i] >= 0]
            out[i, :, : len(gid)] = binning.apply_bins(
                x_i, self.boundaries[gid])
        return common, out


def assign_features(n_features: int, n_parties: int, *, contiguous: bool = True,
                    rng: np.random.Generator | None = None) -> list[np.ndarray]:
    """Split global feature ids across parties (disjoint cover of F).

    ``contiguous=True`` (default) slices features in order — this keeps the
    global tie-break ordering identical between M=1 and M=k runs, which is what
    makes the losslessness check *exact*.  ``contiguous=False`` permutes first
    (the realistic deployment; losslessness then holds up to gain ties).
    """
    ids = np.arange(n_features)
    if not contiguous:
        if rng is None:
            raise ValueError("contiguous=False requires an rng for the feature permutation")
        ids = rng.permutation(ids)
    return [np.sort(a) for a in np.array_split(ids, n_parties)]


def partition_from_blocks(blocks, n_bins: int, *,
                          salt: str = crypto.DEFAULT_SALT,
                          validate: bool = False):
    """Assemble per-party PartyBlocks into the stacked VerticalPartition.

    The canonical party-first ingest path:
      1. order parties canonically (sorted by name — permuting the input
         list cannot change the result);
      2. align on hashed sample IDs (crypto.align_ids): common rows in
         canonical sorted-hash order, superset rows dropped;
      3. bin each block **party-locally** over its aligned rows.  Quantile
         binning is per-feature, so this is lossless by construction —
         bit-identical to binning the assembled central matrix
         (``validate=True`` re-derives the central binning and asserts it);
      4. stack into the (M, N, Fp) padded partition every downstream
         consumer (fit / predict) already speaks.

    Global feature ids are assigned contiguously in canonical party order,
    unless every block carries ``feature_ids`` (they must then partition
    0..F-1 — the raw-matrix compat adapter preserves the original column
    encoding this way).

    Returns ``(partition, y, common_ids)``; ``y`` is the label-holding
    party's labels gathered onto the aligned ordering (None if no party
    holds labels — at most one may).
    """
    blocks = sorted(resolve_blocks(blocks), key=lambda b: b.name)
    common, positions = align_party_blocks(blocks, salt=salt)

    groups, n_features = feature_groups(
        [b.feature_ids for b in blocks], [b.n_features for b in blocks])

    feat_gid = _pad_groups(groups)
    m, fp = feat_gid.shape
    xb = np.zeros((m, len(common), fp), dtype=np.uint8)
    boundaries = np.zeros((n_features, max(n_bins - 1, 0)), dtype=np.float64)
    raw_parts = []
    for i, (b, pos, g) in enumerate(zip(blocks, positions, groups)):
        x_i = b.x[pos]
        if b.feature_ids is not None:           # party-local column order ->
            x_i = x_i[:, np.argsort(b.feature_ids)]  # ascending global id
        xb_i, b_i = binning.bin_dataset(x_i, n_bins)
        xb[i, :, : x_i.shape[1]] = xb_i
        boundaries[g] = b_i
        raw_parts.append(x_i)

    part = VerticalPartition(xb=xb, feat_gid=feat_gid,
                             n_features=n_features, boundaries=boundaries,
                             raw_parts=raw_parts,
                             party_names=tuple(b.name for b in blocks))
    if validate:
        _assert_party_local_binning_lossless(part, n_bins)

    y, holder = None, None
    for b, pos in zip(blocks, positions):
        if b.y is None:
            continue
        if holder is not None:
            raise ValueError(f"labels held by more than one party "
                             f"({holder!r} and {b.name!r}); exactly one "
                             f"party owns the labels")
        holder, y = b.name, b.y[pos]
    return part, y, common


def _assert_party_local_binning_lossless(part: VerticalPartition,
                                         n_bins: int) -> None:
    """Binning is per-feature, so party-local binning of aligned blocks must
    equal central binning of the assembled matrix — assert it (guarded
    behind ``validate=True``: it re-bins the whole dataset).  Raises, not
    ``assert``: the check must survive ``python -O``."""
    xb_central, b_central = binning.bin_dataset(part.dense_raw(), n_bins)
    if not np.array_equal(part.boundaries, b_central):
        raise AssertionError(
            "party-local boundaries diverge from central binning")
    if not np.array_equal(part.xb, _partition_binned(xb_central,
                                                     part.feat_gid)):
        raise AssertionError(
            "party-local binned values diverge from central binning")


def make_vertical_partition(x: np.ndarray, n_parties: int, n_bins: int, *,
                            contiguous: bool = True, seed: int = 0,
                            validate: bool = False) -> VerticalPartition:
    """Split a centrally held, pre-aligned raw (N, F) matrix across
    ``n_parties`` — the thin compat adapter over the party-first path:
    per-party PartyBlocks with identical implicit row IDs take the
    pre-aligned fast path (row order preserved) through
    :func:`partition_from_blocks`."""
    x = np.asarray(x)
    groups = assign_features(x.shape[1], n_parties, contiguous=contiguous,
                             rng=np.random.default_rng(seed))
    ids = np.arange(x.shape[0])
    blocks = [PartyBlock(name=f"party{i:03d}", x=x[:, g], ids=ids,
                         feature_ids=g)
              for i, g in enumerate(groups)]
    part, _, _ = partition_from_blocks(blocks, n_bins, validate=validate)
    return part


def _pad_groups(groups: list[np.ndarray]) -> np.ndarray:
    fp = max(len(g) for g in groups)
    out = np.full((len(groups), fp), -1, dtype=np.int32)
    for i, g in enumerate(groups):
        out[i, : len(g)] = g
    return out


def _partition_binned(xb: np.ndarray, feat_gid: np.ndarray) -> np.ndarray:
    """Gather party-local columns from a globally binned matrix, zero-padding."""
    m, fp = feat_gid.shape
    n = xb.shape[0]
    out = np.zeros((m, n, fp), dtype=np.uint8)
    for i in range(m):
        sel = feat_gid[i] >= 0
        out[i, :, sel] = xb[:, feat_gid[i][sel]].T
    return out
