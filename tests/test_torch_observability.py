"""The port's observability modules (stdlib copies of the JAX package's)
against the JAX modules on the same inputs: registry counters, gauges and
histogram quantiles and their snapshots and merges; span nesting and the
disabled no-op; JSONL, the Chrome trace and the critical-path report of
one span list, equal across packages.  Plus the port's own hooks: the
``torch_profile`` trace (a no-op without a directory) and the serving
engine's wave spans and telemetry."""
import json

import numpy as np
import pytest

from repro.observability import export as jexport
from repro.observability import registry as jregistry
from repro.observability.trace import Tracer as JTracer
from repro_torch.core import ForestParams, fit_federated_forest
from repro_torch.data import make_classification
from repro_torch.observability import (REGISTRY, TRACER, Registry, Tracer,
                                       chrome_trace, critical_path,
                                       export_jsonl, format_report,
                                       read_jsonl, torch_profile)
from repro_torch.observability import registry
from repro_torch.serving import ForestServer


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


def test_serving_records_wave_spans_and_telemetry(tmp_path):
    """A traced serve opens one ``serve.wave`` span per wave, the registry
    counts the waves and rows, and ``profile_dir`` traces the pump."""
    x, y = make_classification(300, 8, 2, seed=3)
    ff = fit_federated_forest(x[:200], y[:200], 2, ForestParams(
        n_estimators=2, max_depth=4, n_bins=16), device="cpu")
    server = ForestServer.from_forest(ff, buckets=(16, 64))
    waves0 = REGISTRY.counter("serving.waves").value
    rows0 = REGISTRY.counter("serving.rows").value
    server.profile_dir = str(tmp_path / "serve")
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
    assert len(list((tmp_path / "serve").glob("trace_*.json"))) == 1
