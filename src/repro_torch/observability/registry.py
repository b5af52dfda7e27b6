"""Process-local telemetry registry: counters, gauges, bounded histograms.

One home for the numbers previously scattered across the system
(`wave_stats` summaries, `FleetMetrics` counters, transport retry
sleeps, queue depths, autotune epochs, streaming chunk/sketch stats).
Metrics are named with dotted paths (``serving.wave_latency_s``); the
worker→coordinator telemetry rollup ships each party's ``snapshot()``
(plain numbers and bounded float sample lists — never arrays of data)
and the coordinator ``merge()``s them under a ``party<i>.`` prefix, so
quantiles can be pooled across parties without new wire types.

Thread-safe (one registry-wide lock; update paths are a few dict/list
ops) and import-light: stdlib only, so the transport layer can use it.
"""
from __future__ import annotations

import collections
import math
import threading

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "REGISTRY",
           "quantile"]

_DEFAULT_SAMPLES = 2048


class Counter:
    __slots__ = ("name", "value", "_lock")

    def __init__(self, name, lock):
        self.name = name
        self.value = 0
        self._lock = lock

    def inc(self, n=1):
        with self._lock:
            self.value += n

    def snapshot(self):
        return {"type": "counter", "value": self.value}


class Gauge:
    __slots__ = ("name", "value", "_lock")

    def __init__(self, name, lock):
        self.name = name
        self.value = 0.0
        self._lock = lock

    def set(self, v):
        with self._lock:
            self.value = float(v)

    def snapshot(self):
        return {"type": "gauge", "value": self.value}


class Histogram:
    """Counts/total plus a bounded reservoir of recent observations.

    The reservoir (a maxlen deque) is what makes quantiles *poolable*:
    snapshots carry the samples, and merged registries re-observe them,
    so cross-party percentiles are computed over the union rather than
    averaging per-party percentiles (which is not a percentile).
    """

    __slots__ = ("name", "count", "total", "max", "_samples", "_lock")

    def __init__(self, name, lock, max_samples=_DEFAULT_SAMPLES):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.max = 0.0
        self._samples = collections.deque(maxlen=max_samples)
        self._lock = lock

    def observe(self, v):
        v = float(v)
        with self._lock:
            self.count += 1
            self.total += v
            if v > self.max:
                self.max = v
            self._samples.append(v)

    def quantile(self, q):
        with self._lock:
            samples = sorted(self._samples)
        return quantile(samples, q)

    def snapshot(self):
        with self._lock:
            return {"type": "histogram", "count": self.count,
                    "total": self.total, "max": self.max,
                    "samples": list(self._samples)}


def quantile(sorted_samples, q):
    """Nearest-rank quantile of an already-sorted list (None if empty)."""
    if not sorted_samples:
        return None
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile q must be in [0, 1], got {q}")
    idx = min(len(sorted_samples) - 1,
              max(0, math.ceil(q * len(sorted_samples)) - 1))
    return sorted_samples[idx]


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}

    def _get(self, name, cls, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, self._lock, **kw)
        if not isinstance(m, cls):
            raise ValueError(
                f"metric {name!r} already registered as {type(m).__name__}")
        return m

    def counter(self, name) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name, max_samples=_DEFAULT_SAMPLES) -> Histogram:
        return self._get(name, Histogram, max_samples=max_samples)

    def get(self, name):
        with self._lock:
            return self._metrics.get(name)

    def names(self):
        with self._lock:
            return sorted(self._metrics)

    def clear(self):
        with self._lock:
            self._metrics.clear()

    def snapshot(self) -> dict:
        """``{name: metric-snapshot-dict}`` — plain numbers only."""
        with self._lock:
            metrics = dict(self._metrics)
        return {name: m.snapshot() for name, m in sorted(metrics.items())}

    def merge(self, snap: dict, prefix: str = ""):
        """Fold a remote ``snapshot()`` into this registry under a prefix.

        Counters add, gauges overwrite, histogram samples re-observe (so
        pooled quantiles see the union of party reservoirs).
        """
        for name, s in (snap or {}).items():
            if not isinstance(s, dict):
                continue
            kind = s.get("type")
            full = prefix + name
            if kind == "counter":
                self.counter(full).inc(s.get("value", 0))
            elif kind == "gauge":
                self.gauge(full).set(s.get("value", 0.0))
            elif kind == "histogram":
                h = self.histogram(full)
                for v in s.get("samples") or ():
                    h.observe(v)
                # count/total reflect all observations, not just the
                # bounded reservoir the snapshot could carry
                extra = s.get("count", 0) - len(s.get("samples") or ())
                if extra > 0:
                    with h._lock:
                        h.count += extra
                        sample_total = sum(s.get("samples") or ())
                        h.total += s.get("total", sample_total) - sample_total


#: Process-wide registry.
REGISTRY = Registry()
