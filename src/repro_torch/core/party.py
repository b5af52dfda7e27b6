"""Vertical partitioning of a dataset across M regional parties.

Mirrors the paper's data distribution (§3.1): identical, pre-aligned sample
space; disjoint feature sets per party.  The partition is stored as
*stacked, padded* host arrays with a leading party axis; a fit moves
them to the device once.

This is the raw-matrix path: a central (N, F) matrix is split into
per-party column blocks and each block is binned party-locally.  Quantile
binning is per feature and the pre-aligned rows keep their order, so the
result is bit-identical to the JAX package's ``make_vertical_partition``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import binning


@dataclasses.dataclass
class VerticalPartition:
    """Vertically partitioned, binned dataset.

    Attributes:
      xb:        (M, N, Fp) uint8 — party-local binned features, zero-padded.
      feat_gid:  (M, Fp) int32    — global (encoded) feature id, -1 for padding.
      n_features: total real features F.
      boundaries: (F, n_bins-1) float64 — per-feature bin boundaries (kept by
                  the owning party only in a real deployment; stored centrally
                  here for test-time re-binning).
    """

    xb: np.ndarray
    feat_gid: np.ndarray
    n_features: int
    boundaries: np.ndarray

    @property
    def n_parties(self) -> int:
        return int(self.xb.shape[0])

    @property
    def n_samples(self) -> int:
        return int(self.xb.shape[1])

    @property
    def n_bins(self) -> int:
        """Bin count this partition was quantized with."""
        return int(self.boundaries.shape[1]) + 1

    def bin_test(self, x_test: np.ndarray) -> np.ndarray:
        """Bin a raw test matrix (N_t, F) and partition it like training data."""
        xb = binning.apply_bins(x_test, self.boundaries)
        return _partition_binned(xb, self.feat_gid)


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


def make_vertical_partition(x: np.ndarray, n_parties: int, n_bins: int, *,
                            contiguous: bool = True,
                            seed: int = 0) -> VerticalPartition:
    """Split a centrally held, pre-aligned raw (N, F) matrix across
    ``n_parties``, binning each party's column block on its own."""
    x = np.asarray(x)
    groups = assign_features(x.shape[1], n_parties, contiguous=contiguous,
                             rng=np.random.default_rng(seed))
    feat_gid = _pad_groups(groups)
    m, fp = feat_gid.shape
    xb = np.zeros((m, x.shape[0], fp), dtype=np.uint8)
    boundaries = np.zeros((x.shape[1], max(n_bins - 1, 0)), dtype=np.float64)
    for i, g in enumerate(groups):
        xb_i, b_i = binning.bin_dataset(x[:, g], n_bins)
        xb[i, :, : len(g)] = xb_i
        boundaries[g] = b_i
    return VerticalPartition(xb=xb, feat_gid=feat_gid,
                             n_features=int(x.shape[1]), boundaries=boundaries)


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
