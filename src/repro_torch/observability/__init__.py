"""Observability for the port: tracing and a telemetry registry.

Three pieces, all stdlib-only on the hot path, copied from the JAX
package's ``repro.observability``:

- :mod:`repro_torch.observability.trace` — hierarchical spans
  (``{"tid", "sid"}`` contexts, ready to ride a transport's frames).
  No-op when disabled; enable with ``REPRO_TRACE=1`` or
  ``TRACER.enable()``.
- :mod:`repro_torch.observability.registry` — counters / gauges /
  bounded histograms with pooled quantiles.
- :mod:`repro_torch.observability.export` — JSONL + Chrome-trace export
  and the critical-path report, plus the opt-in ``torch.profiler`` hook
  ``torch_profile``.

Its callers are the JAX package's: the session's
``collect_telemetry``/``trace_spans``/``export_trace``, the transport and
party workers, and streamed ingest (``streaming.chunks_scanned``,
``streaming.rows_scanned``, ``streaming.rows_binned``,
``streaming.sketch_compactions``; the ``stream.scan`` / ``stream.bin``
events).
"""
from repro_torch.observability.registry import (Counter, Gauge, Histogram,
                                                Registry, REGISTRY)
from repro_torch.observability.trace import TRACER, Tracer, current_context
from repro_torch.observability.export import (chrome_trace, critical_path,
                                              export_jsonl, format_report,
                                              read_jsonl, torch_profile,
                                              write_chrome_trace)

__all__ = [
    "TRACER", "Tracer", "current_context",
    "REGISTRY", "Registry", "Counter", "Gauge", "Histogram",
    "export_jsonl", "read_jsonl", "chrome_trace", "write_chrome_trace",
    "critical_path", "format_report", "torch_profile",
]
