"""Traffic-driven bucket autotuning for the serving engines.

The bucket set is the engine's central padding/compile trade-off: few, large
buckets waste device work on padding rows; many buckets multiply captured
programs (one CUDA graph per bucket on the card: capture time and each
graph's memory pool).  The default set (32/256/2048) is a
hardcoded guess; this module derives one from *observed* traffic instead —
the row-count distribution recorded in ``ModelServer.wave_stats`` (per-wave
``n_rows``) and/or ``RequestQueue.request_stats`` (per-request ``rows``).

The scheme is quantile-based: bucket boundaries sit at the row-count
quantiles of the traffic, rounded up to a pad multiple, capped at
``max_buckets`` programs and always covering the observed maximum (so
steady-state traffic of the sampled shape never recompiles — the
compile-once contract holds per autotune epoch, asserted in
tests/test_torch_serving.py).  With too little traffic the
warm-start set is returned unchanged.

Entry point: ``Federation.serve(model, autotune_buckets=True[, traffic=...])``
refreshes the session's cached server through ``ModelServer.set_buckets``
the same way ``trees_`` changes refresh plans.
"""
from __future__ import annotations

from typing import Iterable

import numpy as np

DEFAULT_QUANTILES = (0.0, 0.5, 0.75, 0.9, 1.0)
DEFAULT_MAX_BUCKETS = 4
MIN_OBSERVATIONS = 8


def observed_row_counts(*stat_streams) -> np.ndarray:
    """Extract row counts from stats records (wave_stats dicts with
    ``n_rows``, request_stats dicts with ``rows``) or plain integers."""
    rows: list[int] = []
    for stream in stat_streams:
        if stream is None:
            continue
        for rec in stream:
            n = (rec.get("n_rows", rec.get("rows"))
                 if isinstance(rec, dict) else rec)
            if n is not None and int(n) > 0:
                rows.append(int(n))
    return np.asarray(rows, np.int64)


def _round_up(n: float, multiple: int) -> int:
    return max(multiple, -(-int(np.ceil(n)) // multiple) * multiple)


def autotune_buckets(traffic: Iterable, *, warm: tuple[int, ...],
                     max_buckets: int = DEFAULT_MAX_BUCKETS,
                     quantiles: tuple[float, ...] = DEFAULT_QUANTILES,
                     pad_multiple: int = 8,
                     min_observations: int = MIN_OBSERVATIONS
                     ) -> tuple[int, ...]:
    """Derive an ascending bucket set from observed traffic.

    ``traffic`` is anything :func:`observed_row_counts` accepts;
    ``warm`` is returned unchanged (normalized) when fewer than
    ``min_observations`` positive row counts were seen — the engine's
    warm-start (DEFAULT_BUCKETS on a fresh server, the current set on a
    retune)."""
    counts = observed_row_counts(traffic)
    if counts.size < min_observations:
        return tuple(sorted(set(int(b) for b in warm)))
    qs = np.quantile(counts, np.clip(quantiles, 0.0, 1.0))
    cand = sorted({_round_up(q, pad_multiple) for q in qs})
    # the largest bucket must cover the observed max (waves above it would
    # micro-batch fine, but the quantile already IS the max at q=1.0)
    top = _round_up(int(counts.max()), pad_multiple)
    if cand[-1] < top:
        cand.append(top)
    if len(cand) > max_buckets:
        # thin evenly but always keep the largest (it bounds wave size)
        keep_idx = np.linspace(0, len(cand) - 1, max_buckets)
        cand = sorted({cand[int(round(i))] for i in keep_idx})
    return tuple(cand)
