"""Mergeable quantile sketches — out-of-core party-local binning.

The in-memory data plane derives each party's bin edges with one
``np.quantile`` over the party's full raw column (core/binning.py).  A silo
extract that doesn't fit in RAM can't do that, so the streaming plane feeds
every chunk through a :class:`QuantileSketch` — an MRL/KLL-style compactor —
and cuts the bin grid from the sketch instead.

Two regimes, one object:

* **Exact** — while the sketch has never compacted (total items within
  ``capacity``), it *is* the data: ``edges(n_bins)`` calls ``np.quantile``
  on the buffered values at exactly the grid levels
  (:func:`repro_torch.core.binning.interior_quantiles`), so the resulting
  edges are **bit-identical** to the dense in-memory build.  This is the regime
  the losslessness oracle (streamed build == in-memory build) runs in.

* **Compacted** — past capacity, levels compact: the level-``l`` buffer
  (every element weighing ``2**l``) is sorted and every other element of its
  even-length prefix is promoted to level ``l+1`` with doubled weight.  For
  any threshold ``t``, if ``c`` of the ``m`` even-prefix elements are
  ``<= t``, the promoted set holds ``floor((c + 1 - offset) / 2)`` of them
  (``offset`` alternates 0/1 per compaction), so the weighted
  rank of ``t`` moves by ``|w*c - 2w*floor((c+1-offset)/2)| <= w = 2**l``;
  the odd remainder is untouched.  Each compaction therefore adds at most
  ``2**l`` to the absolute rank error, and the sketch *tracks that sum
  exactly* in :attr:`err`: every rank answered is within ``err`` of truth.
  With capacity ``k``, level ``l`` compacts about ``n / (k * 2**l)`` times
  over ``n`` items, giving the classic ``err/n ~= log2(n/k) / k`` relative
  bound.

Merging concatenates level-wise and re-compacts; bounds add
(``merged.err <= a.err + b.err + compaction cost``, all tracked).  Merge is
order-invariant in the exact regime (the buffer is a multiset) and
bound-respecting in the compacted one.

The same sketch as the JAX package's ``repro.streaming.sketch`` (host-side
NumPy): the same compactions in the same order, so both packages give the
same edges and the same ``err`` on the same stream, and both count each
compaction on ``streaming.sketch_compactions``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import binning
from repro_torch.observability import registry as telemetry

DEFAULT_CAPACITY = 2048


class QuantileSketch:
    """Deterministic mergeable rank sketch over one feature column.

    Args:
      capacity: per-level buffer size that triggers compaction.  Memory is
        ``O(capacity * log(n / capacity))`` floats regardless of stream
        length.  Streams with at most ``capacity`` total values never
        compact and stay exact (``err == 0``).
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity < 8:
            raise ValueError(f"capacity must be >= 8, got {capacity}")
        self.capacity = int(capacity)
        # levels[l]: unordered float64 buffer whose elements each weigh 2**l
        self.levels: list[np.ndarray] = [np.empty(0, dtype=np.float64)]
        self.n = 0          # total values observed (exact count, always)
        self.err = 0        # proven additive rank-error bound (0 == exact)
        self._parity = 0    # alternating compaction offset (deterministic)

    # --------------------------------------------------------------- build
    def update(self, values) -> "QuantileSketch":
        """Absorb a chunk of values; returns self for chaining."""
        v = np.asarray(values, dtype=np.float64).reshape(-1)
        if not np.isfinite(v).all():
            raise ValueError("QuantileSketch.update: non-finite values "
                             "(NaN/inf) have no rank — clean them upstream")
        if v.size == 0:
            return self
        self.levels[0] = np.concatenate([self.levels[0], v])
        self.n += int(v.size)
        self._compress()
        return self

    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        """Combine two sketches into a new one; inputs are untouched.
        Error bounds add (then grow by any re-compaction, still tracked)."""
        out = QuantileSketch(capacity=min(self.capacity, other.capacity))
        depth = max(len(self.levels), len(other.levels))
        out.levels = []
        for l in range(depth):
            mine = self.levels[l] if l < len(self.levels) \
                else np.empty(0, dtype=np.float64)
            theirs = other.levels[l] if l < len(other.levels) \
                else np.empty(0, dtype=np.float64)
            out.levels.append(np.concatenate([mine, theirs]))
        out.n = self.n + other.n
        out.err = self.err + other.err
        out._parity = (self._parity + other._parity) % 2
        out._compress()
        return out

    def _compress(self) -> None:
        """Compact every over-capacity level upward (weights double)."""
        l = 0
        while l < len(self.levels):
            buf = self.levels[l]
            if buf.size <= self.capacity:
                l += 1
                continue
            buf = np.sort(buf, kind="stable")
            offset, self._parity = self._parity, self._parity ^ 1
            m = buf.size - (buf.size % 2)        # even prefix compacts;
            promoted = buf[:m][offset::2]        # odd remainder stays put
            self.levels[l] = buf[m:]
            if l + 1 == len(self.levels):
                self.levels.append(np.empty(0, dtype=np.float64))
            self.levels[l + 1] = np.concatenate(
                [self.levels[l + 1], promoted])
            self.err += 2 ** l
            telemetry.REGISTRY.counter("streaming.sketch_compactions").inc()
            l += 1

    # --------------------------------------------------------------- query
    @property
    def exact(self) -> bool:
        """True while no compaction ever happened — quantiles are exact and
        bit-identical to np.quantile over the streamed values."""
        return self.err == 0

    def quantiles(self, qs) -> np.ndarray:
        """Quantile estimates at levels ``qs`` (np.quantile's linear method).

        Exact regime: literally ``np.quantile`` on the buffer.  Compacted:
        weighted interpolation over the level-stacked multiset — every
        answer's rank is within :attr:`err` of the true rank.
        """
        if self.n == 0:
            raise ValueError("empty sketch has no quantiles")
        qs = np.asarray(qs, dtype=np.float64).reshape(-1)
        if self.exact:
            return np.quantile(self.levels[0], qs)
        vals = np.concatenate(self.levels)
        wts = np.concatenate([np.full(lv.size, 2 ** l, dtype=np.int64)
                              for l, lv in enumerate(self.levels)])
        order = np.argsort(vals, kind="stable")
        vals, wts = vals[order], wts[order]
        cw = np.cumsum(wts)                      # cw[-1] == self.n
        pos = (cw[-1] - 1) * qs                  # np.quantile: (n-1) * q
        lo = np.minimum(np.searchsorted(cw, np.floor(pos) + 1, side="left"),
                        vals.size - 1)
        hi = np.minimum(np.searchsorted(cw, np.ceil(pos) + 1, side="left"),
                        vals.size - 1)
        frac = pos - np.floor(pos)
        return vals[lo] * (1.0 - frac) + vals[hi] * frac

    def edges(self, n_bins: int) -> np.ndarray:
        """The ``n_bins - 1`` interior bin edges, cut at exactly the grid
        levels the dense build uses (binning.interior_quantiles)."""
        return np.asarray(
            self.quantiles(binning.interior_quantiles(n_bins)),
            dtype=np.float64)

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return (f"QuantileSketch(n={self.n}, err={self.err}, "
                f"levels={[lv.size for lv in self.levels]})")


class FeatureSketches:
    """One :class:`QuantileSketch` per feature column of a party block —
    the unit a streaming scan builds and the bin-edge derivation consumes.
    """

    def __init__(self, n_features: int, capacity: int = DEFAULT_CAPACITY):
        self.sketches = [QuantileSketch(capacity)
                         for _ in range(int(n_features))]

    @property
    def n_features(self) -> int:
        return len(self.sketches)

    @property
    def n(self) -> int:
        return self.sketches[0].n if self.sketches else 0

    @property
    def err(self) -> int:
        """The worst per-feature tracked rank-error bound."""
        return max((s.err for s in self.sketches), default=0)

    @property
    def exact(self) -> bool:
        return self.err == 0

    def update(self, x: np.ndarray) -> "FeatureSketches":
        x = np.asarray(x, dtype=np.float64)
        if x.ndim != 2 or x.shape[1] != self.n_features:
            raise ValueError(f"expected (n, {self.n_features}) chunk, got "
                             f"shape {x.shape}")
        for f, s in enumerate(self.sketches):
            s.update(x[:, f])
        return self

    def merge(self, other: "FeatureSketches") -> "FeatureSketches":
        if self.n_features != other.n_features:
            raise ValueError(
                f"cannot merge sketches over {self.n_features} vs "
                f"{other.n_features} features")
        out = FeatureSketches.__new__(FeatureSketches)
        out.sketches = [a.merge(b)
                        for a, b in zip(self.sketches, other.sketches)]
        return out

    def edges(self, n_bins: int) -> np.ndarray:
        """Per-feature boundary grid, shape (F, n_bins - 1) — the streamed
        stand-in for binning.quantile_boundaries (bit-identical while
        :attr:`exact`)."""
        return np.stack([s.edges(n_bins) for s in self.sketches]) \
            if self.sketches \
            else np.empty((0, max(n_bins - 1, 0)), dtype=np.float64)
