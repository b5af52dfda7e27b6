"""The span sub-window: a second profiled sub-window of a ``--trace 1``
run, with the program's tracer on, for the per-layer metrics that read the
program's own spans and counters.

The first sub-window (``harness.run_cell``) runs with the tracer off, so
every metric that reads ``ctx.profile``, ``ctx.counters`` or ``ctx.spans``
reads what it read before this module existed.  This one runs when the
first reader of a program span asks for it, after the harness has read the
memory peak, released the program and judged it: a driver of the cell's
kind, on a context of its own, sets the cell up again from the same seed
(the table, ingest, warm-up, all untraced), then runs the same
``traced_unit`` under the profiler with ``TRACER`` on.  The tracer mirrors
each of the program's context-manager spans into the profiler as a host
range, so each idle gap of the device (longer than ``trace.GAP_FLOOR_NS``)
is put down to the innermost program span open at its middle on the
issuing thread; gaps under no program span go to ``outside``: the
harness, its load generator and sleeps.

A program without these spans or counters (an older commit) leaves the
readers nothing to find: they return None.  The reading is kept on the
context as ``ctx.span_window``; a failure is noted on standard error and
reads as None, so the run's result line stays whole.
"""
from __future__ import annotations

import json
import sys
import time

import torch

from bench import trace

COUNTERS = ("forest.staged_bytes", "forest.host_syncs")
OUTSIDE = "outside"         # idle under no program span


def _note(msg: str) -> None:
    print(f"bench: {msg}", file=sys.stderr, flush=True)


def _profile_events(fn, device):
    """``trace.profile``'s session, returning its raw events and window."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.autograd import (_disable_profiler, _enable_profiler,
                                _prepare_profiler)
    from torch.autograd.profiler import ProfilerConfig, ProfilerState
    from torch.profiler import ProfilerActivity
    cuda = torch.device(device).type == "cuda"
    acts = {ProfilerActivity.CPU} | ({ProfilerActivity.CUDA} if cuda
                                     else set())
    cfg = ProfilerConfig(ProfilerState.KINETO, False, False, False, False,
                         False, _ExperimentalConfig())
    _prepare_profiler(cfg, acts)
    _enable_profiler(cfg, acts)
    try:
        t0 = time.perf_counter()
        fn()
        if cuda:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    finally:
        events = _disable_profiler().events()
    return events, window_s


def idle_by_span(events, names) -> tuple[float, dict[str, float]]:
    """The device's busy seconds, and the seconds of its idle gaps (as
    ``trace.reduce_events`` finds them) by the innermost host range named
    in ``names`` open at each gap's middle, ``OUTSIDE`` where none is.

    A range also shows on the device's timeline, as an annotation of its
    name over the work launched inside it: that is no device operation."""
    dev_type = torch.autograd.DeviceType.CUDA
    ops = sorted((e.start_ns(), e.end_ns()) for e in events
                 if e.device_type() == dev_type and e.name() not in names)
    gaps, end = [], None
    for a, b in ops:
        if end is not None and a - end > trace.GAP_FLOOR_NS:
            gaps.append((end, a))
        end = b if end is None else max(end, b)
    ranges = [(e.start_ns(), e.end_ns(), e.name(), e.start_thread_id())
              for e in events
              if e.device_type() != dev_type and e.name() in names]
    out = trace._attribute(gaps, ranges)
    if "python" in out:
        out[OUTSIDE] = out.pop("python")
    return trace._union(ops) / 1e9, out


def _counters() -> dict:
    from repro_torch.observability import registry
    return {name: getattr(registry.REGISTRY.get(name), "value", None)
            for name in COUNTERS}


def _run(ctx) -> dict:
    from bench import harness
    from repro_torch.observability.trace import TRACER
    sub = harness.Context(ctx.spec, ctx.cell, ctx.config, ctx.mix, ctx.seed,
                          ctx.device)
    drv = harness.driver_class(ctx.mix["driver"])(sub)
    t0 = time.perf_counter()
    drv.setup()
    setup_s = time.perf_counter() - t0
    unit = drv.traced_unit()
    was_on = TRACER.enabled
    TRACER.drain()
    before = _counters()
    TRACER.enable()
    try:
        events, window_s = _profile_events(unit, sub.device)
    finally:
        if not was_on:
            TRACER.disable()
        spans = TRACER.drain()
    after = _counters()
    session = drv.s
    vars(drv).clear()               # the server, the queue, the fits
    session.close()
    busy_s, idle = idle_by_span(events, {s["name"] for s in spans})
    out = {"spans": spans, "busy_s": busy_s, "window_s": window_s,
           "idle": idle,
           "counters": {k: (None if before[k] is None or after[k] is None
                            else after[k] - before[k]) for k in COUNTERS},
           "fits": sub.counters.get("traced_fits")}
    _note(f"span window: set-up {setup_s:.2f} s, traced {window_s:.2f} s, "
          f"{len(spans)} spans, busy {busy_s:.3f} s; idle by program "
          f"span (s): " + json.dumps(dict(sorted(
              out["idle"].items(), key=lambda t: -t[1]))))
    return out


def window(ctx) -> dict | None:
    """The span sub-window's reading of this run (run on first use):
    ``spans`` (the tracer's), ``busy_s``, ``window_s``, ``idle`` (device
    idle seconds by innermost program span), ``counters`` (deltas of
    ``COUNTERS``, None where the program lacks one), ``fits`` (the traced
    fits of a fit cell)."""
    if not hasattr(ctx, "span_window"):
        ctx.span_window = None
        try:
            ctx.span_window = _run(ctx)
        except Exception as err:    # a diagnostic window: the run goes on
            _note(f"span window failed: {type(err).__name__}: {err}")
    return ctx.span_window


def durations(w: dict, name: str) -> list[float]:
    """Seconds of each span named ``name`` in the window."""
    return [s["dur"] for s in w["spans"] if s["name"] == name]
