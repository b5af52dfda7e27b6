"""The port's observability modules (stdlib copies of the JAX package's)
against the JAX modules on the same inputs: registry counters, gauges and
histogram quantiles and their snapshots and merges; span nesting and the
disabled no-op; JSONL, the Chrome trace and the critical-path report of
one span list, equal across packages.  Plus the port's own hooks: the
``torch_profile`` trace (a no-op without a directory), the serving
engine's wave spans and telemetry, asynchronous spans kept off the
nesting stack, spans mirrored into a running profiler on its clock, and
the spans and counters of a traced fit and a traced queue drain."""
import json

import numpy as np
import pytest

from repro.observability import export as jexport
from repro.observability import registry as jregistry
from repro.observability.trace import Tracer as JTracer
from repro_torch.core import ForestParams, fit_federated_forest
from repro_torch.core.party import make_vertical_partition
from repro_torch.data import make_classification, make_regression
from repro_torch.observability import (REGISTRY, TRACER, Registry, Tracer,
                                       chrome_trace, critical_path,
                                       export_jsonl, format_report,
                                       read_jsonl, torch_profile)
from repro_torch.observability import registry
from repro_torch.observability import trace as trace_mod
from repro_torch.serving import ForestServer, RequestQueue


@pytest.fixture()
def tracer():
    t = Tracer()
    t.enable()
    yield t
    t.disable()
    t.reset()


def _fill(reg):
    reg.counter("a.hits").inc()
    reg.counter("a.hits").inc(4)
    reg.gauge("a.depth").set(7)
    h = reg.histogram("a.lat", max_samples=16)
    for v in np.random.default_rng(0).random(40):
        h.observe(float(v))
    return reg


def test_registry_equals_jax_on_the_same_observations():
    mine, theirs = _fill(Registry()), _fill(jregistry.Registry())
    assert mine.snapshot() == theirs.snapshot()
    for q in (0.0, 0.25, 0.5, 0.95, 0.99, 1.0):
        assert (mine.histogram("a.lat").quantile(q)
                == theirs.histogram("a.lat").quantile(q))
    samples = sorted(np.random.default_rng(1).random(33).tolist())
    for q in (0.1, 0.5, 0.9):
        assert registry.quantile(samples, q) == jregistry.quantile(samples, q)
    with pytest.raises(ValueError, match="already registered"):
        mine.gauge("a.hits")
    a, b = Registry(), jregistry.Registry()
    for reg in (a, b):
        reg.merge(mine.snapshot(), prefix="party1.")
        reg.merge(mine.snapshot(), prefix="party1.")
    assert a.snapshot() == b.snapshot()
    assert a.histogram("party1.a.lat").count == 80        # overflow counted


def test_disabled_tracer_is_noop():
    t = Tracer()
    s1, s2 = t.span("a"), t.span("b", category="comm", level=3)
    assert s1 is s2
    with s1:
        assert t.current_context() is None
    assert t.begin("c") is None
    t.finish(None)
    t.event("d")
    assert t.spans() == []


def _demo(t):
    with t.span("root", category="host"):
        with t.span("mid", category="comm", level=0):
            with t.span("leaf", category="compute"):
                pass
        t.event("blip", category="host")
    with t.attach({"tid": "t9", "sid": "coord/9"}):
        with t.span("remote_child", category="compute", level=1):
            pass
    return t.spans()


def test_span_nesting_equals_jax(tracer):
    """The same calls give the same span tree in both packages (names,
    categories, parent links, attrs), and attrs reject arrays."""
    mine = _demo(tracer)
    jt = JTracer(process=tracer.process)
    jt.enable()
    theirs = _demo(jt)

    def shape(spans):
        ids = {s["sid"]: s["name"] for s in spans}
        return [(s["name"], s["cat"], ids.get(s["parent"], s["parent"]),
                 s["attrs"]) for s in spans]
    assert shape(mine) == shape(theirs)
    by = {s["name"]: s for s in mine}
    assert by["leaf"]["parent"] == by["mid"]["sid"]
    assert by["remote_child"]["tid"] == "t9"
    with pytest.raises(TypeError, match="metadata"):
        tracer.event("bad", rows=np.arange(5))


def test_export_and_report_equal_jax(tracer, tmp_path):
    """One span list through both packages' exporters: equal JSONL, Chrome
    trace, critical path and report text."""
    spans = _demo(tracer)
    path = tmp_path / "spans.jsonl"
    export_jsonl(spans, str(path))
    assert read_jsonl(str(path)) == spans == jexport.read_jsonl(str(path))
    doc = chrome_trace(spans)
    assert doc == jexport.chrome_trace(spans)
    assert len([e for e in doc["traceEvents"] if e["ph"] == "X"]) == len(spans)
    json.dumps(doc)
    assert critical_path(spans) == jexport.critical_path(spans)
    assert format_report(spans) == jexport.format_report(spans)
    assert {"host", "comm", "compute"} == set(
        critical_path(spans)["by_category_s"])


def test_torch_profile_writes_a_chrome_trace(tmp_path):
    import torch
    with torch_profile(None):                    # falsy: no-op
        torch.ones(3).sum()
    with torch_profile(str(tmp_path / "prof")):
        torch.ones(64, 64).matmul(torch.ones(64, 64))
    files = list((tmp_path / "prof").glob("trace_*.json"))
    assert len(files) == 1
    assert "traceEvents" in json.loads(files[0].read_text())


def test_serving_records_wave_spans_and_telemetry():
    """A traced serve opens one ``serve.wave`` span per wave and the
    registry counts the waves and rows."""
    x, y = make_classification(300, 8, 2, seed=3)
    ff = fit_federated_forest(x[:200], y[:200], 2, ForestParams(
        n_estimators=2, max_depth=4, n_bins=16), device="cpu")
    server = ForestServer.from_forest(ff, buckets=(16, 64))
    waves0 = REGISTRY.counter("serving.waves").value
    rows0 = REGISTRY.counter("serving.rows").value
    TRACER.enable()
    try:
        TRACER.reset()
        out = server.serve(x[200:280])
        spans = [s for s in TRACER.spans() if s["name"] == "serve.wave"]
    finally:
        TRACER.disable()
        TRACER.reset()
    np.testing.assert_array_equal(out, ff.predict(x[200:280]))
    assert [s["attrs"]["bucket"] for s in spans] == [64, 16]
    assert REGISTRY.counter("serving.waves").value - waves0 == 2
    assert REGISTRY.counter("serving.rows").value - rows0 == 80


def test_overlapping_async_spans_are_siblings(tracer):
    """Two waves in flight at once are siblings under the drain, and host
    work opened while they are in flight parents under the drain too, not
    under a wave; finishing a wave leaves the stack alone."""
    with tracer.span("queue.drain"):
        w0 = tracer.begin("serve.wave", category="compute", n=0)
        w1 = tracer.begin("serve.wave", category="compute", n=1)
        with tracer.span("between"):
            pass
        tracer.finish(w0)
        with tracer.span("after"):
            pass
        tracer.finish(w1)
        assert tracer.current_context()["sid"] != w1.sid
    assert tracer.current_context() is None
    by = {(s["name"], s["attrs"].get("n")): s for s in tracer.spans()}
    drain = by[("queue.drain", None)]["sid"]
    for key in (("serve.wave", 0), ("serve.wave", 1), ("between", None),
                ("after", None)):
        assert by[key]["parent"] == drain, key


def _kineto_events(fn):
    """Run ``fn`` under the low-level Kineto session the benchmark opens
    (CPU activity only); returns the raw events."""
    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.autograd import (_disable_profiler, _enable_profiler,
                                _prepare_profiler)
    from torch.autograd.profiler import ProfilerConfig, ProfilerState
    from torch.profiler import ProfilerActivity
    acts = {ProfilerActivity.CPU}
    cfg = ProfilerConfig(ProfilerState.KINETO, False, False, False, False,
                         False, _ExperimentalConfig())
    _prepare_profiler(cfg, acts)
    _enable_profiler(cfg, acts)
    try:
        fn()
    finally:
        events = _disable_profiler().events()
    return events


def test_span_mirrors_into_a_running_profiler(tracer):
    """Under a Kineto session a context-manager span is a host event of its
    name enclosing the ops it ran, and the tracer's epoch ``t0`` and
    ``dur`` agree with the event's start and length within 200 us; an
    asynchronous span is not mirrored.  (A process's first range pays a
    one-time import inside ``record_function``: a span opens it first.)"""
    import torch
    a = torch.ones(256, 256)

    def work():
        with tracer.span("x.first"):
            pass
        with tracer.span("x.mirror"):
            a.matmul(a)
        tracer.finish(tracer.begin("x.async"))
    events = _kineto_events(work)
    (mine,) = [s for s in tracer.spans() if s["name"] == "x.mirror"]
    (ev,) = [e for e in events if e.name() == "x.mirror"]
    assert not [e for e in events if e.name() == "x.async"]
    mm = [e for e in events if e.name() in ("aten::matmul", "aten::mm")]
    assert mm and all(ev.start_ns() <= e.start_ns() <= e.end_ns()
                      <= ev.end_ns() for e in mm)
    assert abs(mine["t0"] * 1e9 - ev.start_ns()) < 200e3
    assert abs(mine["dur"] * 1e9 - (ev.end_ns() - ev.start_ns())) < 200e3


def test_no_profiler_range_without_a_session(tracer):
    """With no profiler session a span opens no range; with the tracer off
    ``span()`` is still the shared no-op."""
    import torch
    assert not torch.autograd._profiler_enabled()
    with tracer.span("x") as h:
        assert h._range is None
    off = Tracer()
    assert off.span("x") is trace_mod._NOOP
    assert off.begin("y") is None and off.spans() == []


def _traced(fn):
    """``fn()`` with the process tracer on; returns (result, spans)."""
    TRACER.enable()
    try:
        TRACER.reset()
        out = fn()
        spans = TRACER.spans()
    finally:
        TRACER.disable()
        TRACER.reset()
    return out, spans


def test_traced_fit_spans_and_counters():
    """A traced fit with frontier levels: one ``tree.level`` a level a tree
    (``level``, ``path``, ``passes``), ``fit.randomness`` and ``fit.stage``
    under ``fit.prepare``, one host sync a frontier level a tree, the staged
    bytes those of the operands' shapes, a non-empty per-level report, and
    the same trees as an untraced fit."""
    x, y = make_regression(240, 7, seed=5)
    p = ForestParams(task="regression", n_estimators=2, max_depth=5,
                     n_bins=8, seed=3, frontier_cap=3)
    part = make_vertical_partition(x, 2, p.n_bins, seed=p.seed)
    from repro_torch.core import FederatedForest
    syncs = REGISTRY.counter("forest.host_syncs")
    staged = REGISTRY.counter("forest.staged_bytes")
    s0, b0 = syncs.value, staged.value
    ff, spans = _traced(
        lambda: FederatedForest(p, device="cpu").fit(part, y))
    s1, b1 = syncs.value, staged.value
    plain = FederatedForest(p, device="cpu").fit(part, y)
    for f in ff.trees_._fields:
        assert np.array_equal(getattr(ff.trees_, f).numpy(),
                              getattr(plain.trees_, f).numpy()), f
    # levels 0..5, widths 1..32; cap 3: levels 2, 3, 4 run compacted
    levels = [s for s in spans if s["name"] == "tree.level"]
    assert sorted((s["attrs"]["tree"], s["attrs"]["level"])
                  for s in levels) == [(t, d) for t in range(2)
                                       for d in range(6)]
    path = {s["attrs"]["level"]: s["attrs"]["path"] for s in levels}
    assert path == {0: "dense", 1: "dense", 2: "frontier", 3: "frontier",
                    4: "frontier", 5: "leaf"}
    for s in levels:
        if s["attrs"]["path"] == "frontier":
            assert s["attrs"]["passes"] >= 1
    live = [s for s in spans if s["name"] == "tree.live_count"]
    level_sid = {s["sid"]: s["attrs"]["level"] for s in levels}
    assert sorted(level_sid[s["parent"]] for s in live) == [2, 2, 3, 3, 4, 4]
    assert s1 - s0 == 2 * 3
    by = {s["name"]: s for s in spans}
    assert by["fit.randomness"]["parent"] == by["fit.prepare"]["sid"]
    assert by["fit.stage"]["parent"] == by["fit.prepare"]["sid"]
    assert by["fit.prepare"]["attrs"] == {"rows": 240, "trees": 2}
    m, n, fp = part.xb.shape
    want = (m * n * fp                      # uint8 bins
            + m * fp * 4                    # int32 global feature ids
            + np.asarray(y).nbytes          # labels
            + 2 * n * 4                     # float32 bootstrap weights
            + 2 * 7)                        # bool feature selections
    assert b1 - b0 == want
    assert by["fit.stage"]["attrs"]["bytes"] == want
    cp = critical_path(spans)
    assert sorted(cp["levels"]) == list(range(6))
    assert all(v["spans"] == 2 for v in cp["levels"].values())
    assert "per-level" in format_report(spans)


def test_traced_queue_drain_spans():
    """A traced drain at ``max_inflight`` 2: a ``queue.bin`` a request's
    piece of a wave, ``serve.dispatch`` / ``serve.collect`` a wave, the
    waves siblings under ``queue.drain``, each ``queue.wait`` finished when
    its first rows are dispatched, and the answers bit-identical to an
    untraced drain."""
    x, y = make_classification(400, 8, 2, seed=3)
    ff = fit_federated_forest(x[:200], y[:200], 2, ForestParams(
        n_estimators=2, max_depth=4, n_bins=16), device="cpu")
    server = ForestServer.from_forest(ff, buckets=(16, 64), max_inflight=2)
    sizes = [5, 30, 20, 50, 10]      # waves of 64 (5, 30, 20, 9) and 51

    def run():
        q = RequestQueue(server)
        at = 200
        for k in sizes:
            q.submit(x[at:at + k])
            at += k
        return q.drain()
    got, spans = _traced(run)
    want = run()
    assert sorted(got) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    names = [s["name"] for s in spans]
    (drain,) = [s for s in spans if s["name"] == "queue.drain"]
    bins = [s for s in spans if s["name"] == "queue.bin"]
    assert [s["attrs"]["rows"] for s in bins] == [5, 30, 20, 9, 41, 10]
    waves = [s for s in spans if s["name"] == "serve.wave"]
    assert len(waves) == 2
    assert names.count("serve.dispatch") == names.count("serve.collect") == 2
    for s in waves + bins:
        assert s["parent"] == drain["sid"], s["name"]
    for s in spans:
        if s["name"] in ("serve.dispatch", "serve.collect"):
            assert s["parent"] == drain["sid"]
    dispatch = [i for i, n in enumerate(names) if n == "serve.dispatch"]
    waits = [i for i, n in enumerate(names) if n == "queue.wait"]
    assert [spans[i]["attrs"]["rows"] for i in waits] == sizes
    # requests 0-3 start in the first wave, request 4 in the second
    assert max(waits[:4]) < dispatch[0] < waits[4] < dispatch[1]
