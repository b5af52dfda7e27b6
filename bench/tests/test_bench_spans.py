"""The span sub-window (``bench/spans.py``) and the metrics that read it:
each reads a number on a ``--trace 1`` run of a small copy of its cell,
the sub-window leaves what the first one left untouched, and idle gaps go
to the innermost program span at their middle."""
from __future__ import annotations

import copy
import time

import pytest

from bench import harness, spans, trace
from bench.tests.conftest import small_config, small_mix

FIT = ("fit_prepare_ms", "staged_mb_per_fit", "host_syncs_per_fit",
       "level_idle_ms")
SERVE = ("bin_ms_per_krow", "queue_wait_p95_ms", "dispatch_ms_per_wave")
# a device metric: a CPU run has no device trace, so it reads None here
DEVICE_ONLY = {"level_idle_ms"}

CELLS = {"ff-year.fit": ("ff-year", "fit_loop", FIT,
                         dict(n=3000, f=7, trees=2, depth=4, cap=4)),
         "ff-kdd99.serve": ("ff-kdd99", "serve_open", SERVE,
                            dict(n=6000, f=11, trees=3, depth=4))}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_new_metrics_read_numbers_and_leave_the_first_window(
        spec, cell, monkeypatch):
    """A traced CPU run of a small copy of the cell reports each new
    metric (its device metric aside), and every reader, the new ones
    included, meets the same ``ctx.profile``, ``ctx.counters`` and
    ``ctx.spans`` as the first sub-window left them; the ``breakdown`` is
    the first sub-window's."""
    cfg_name, mix_name, names, size = CELLS[cell]
    seen = []
    reader_of = harness.metric_reader

    def watched(name):
        read = reader_of(name)

        def wrapped(ctx):
            seen.append(copy.deepcopy((ctx.profile, ctx.counters,
                                       ctx.spans)))
            out = read(ctx)
            seen.append(copy.deepcopy((ctx.profile, ctx.counters,
                                       ctx.spans)))
            return out
        return wrapped
    monkeypatch.setattr(harness, "metric_reader", watched)
    r = harness.run_cell(spec, cell, 2 ** 40 + 7, 0.2, True,
                         t_start=time.perf_counter(), device="cpu",
                         config=small_config(spec, cfg_name, **size),
                         mix=small_mix(mix_name))
    assert r["correct"] is True
    for name in names:
        if name in DEVICE_ONLY:
            assert name not in r["metrics"]
        else:
            assert r["metrics"][name]["value"] >= 0, name
    assert len(seen) == 2 * len(harness.cell_metrics_layer(spec, cell))
    assert all(s == seen[0] for s in seen)
    assert r["breakdown"] == trace.breakdown(seen[0][0])
    assert set(seen[0][1]) == ({"fits", "hist_launches_per_fit",
                                "traced_fits"} if cell.endswith(".fit")
                               else {"waves", "rows", "traced_rows"})


def test_fit_counters_per_fit(spec):
    """At depth 4 under a frontier cap of 4 the fit compacts levels 3 (a
    width of 8), so a fit reads the host one live count a tree; the staged
    bytes are the operands' (bins, feature ids, labels, weights, draws)."""
    cfg = small_config(spec, "ff-year", n=3000, f=7, trees=2, depth=4,
                       cap=4)
    r = harness.run_cell(spec, "ff-year.fit", 99, 0.2, True,
                         t_start=time.perf_counter(), device="cpu",
                         config=cfg, mix=small_mix("fit_loop"))
    assert r["metrics"]["host_syncs_per_fit"]["value"] == 2
    n = 3000 - round(3000 * cfg["test_frac"])
    fp = 4                                  # 7 features over 2 parties
    want = (2 * n * fp + 2 * fp * 4 + n * 8 + 2 * n * 4 + 2 * 7) / 1e6
    assert r["metrics"]["staged_mb_per_fit"]["value"] == pytest.approx(
        want, rel=0, abs=1e-12)


class _Ev:
    """A raw profiler event as ``bench/trace.py`` reads it."""

    def __init__(self, name, a, b, device=False, thread=1):
        import torch
        self._n, self._a, self._b, self._t = name, a, b, thread
        self._d = (torch.autograd.DeviceType.CUDA if device
                   else torch.autograd.DeviceType.CPU)

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._a

    def end_ns(self):
        return self._b

    def start_thread_id(self):
        return self._t


def test_idle_gaps_go_to_the_innermost_program_span():
    """Device ops at 0-10, 20-30, 40-41 and 60-70 us leave gaps at 10-20,
    30-40 (a child span at its middle), 41-60; the ``aten`` op inside the
    level is not a program span, so the level keeps its gap; a gap no
    program range covers goes to ``outside``; one under the floor is
    none; the levels' annotation on the device's timeline is no device
    operation."""
    us = 1000
    ev = [_Ev("k", 0, 10 * us, True), _Ev("k", 20 * us, 30 * us, True),
          _Ev("k", 40 * us, 41 * us, True), _Ev("k", 60 * us, 70 * us, True),
          _Ev("k", 70 * us + 500, 80 * us, True),
          _Ev("fit.ForestParams", 0, 45 * us),
          _Ev("tree.level", 5 * us, 38 * us),
          _Ev("aten::where", 12 * us, 18 * us),
          _Ev("tree.live_count", 33 * us, 37 * us),
          _Ev("tree.level", 0, 41 * us, True)]
    names = {"fit.ForestParams", "tree.level", "tree.live_count"}
    busy, got = spans.idle_by_span(ev, names)
    assert got == {"tree.level": 10e-6, "tree.live_count": 10e-6,
                   spans.OUTSIDE: 19e-6}
    assert busy == pytest.approx(40.5e-6, abs=1e-12)
