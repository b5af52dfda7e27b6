"""Span export: JSONL, Chrome trace-event JSON, critical-path summary.

``export_jsonl``/``read_jsonl`` round-trip the tracer's span dicts one
JSON object per line.  ``chrome_trace`` converts them to the Chrome
trace-event format (open in ``chrome://tracing`` or
https://ui.perfetto.dev): one complete ("X") event per span, with
process-name metadata events so the coordinator and each party show as
separate tracks.  ``critical_path`` attributes wall-clock to
comm / compute / host by *self time* (a span's duration minus its
children's), so nested spans never double count, and breaks the fit
down per level and per process.

``torch_profile(logdir)`` is the opt-in ``torch.profiler`` hook (the
JAX package's ``jax_profile``): a context manager that traces the block
(the host, and the card when there is one) and writes a Chrome trace into
``logdir`` when a directory is given, and is a no-op otherwise (torch is
imported lazily, so this module stays stdlib-only on the disabled path).
"""
from __future__ import annotations

import contextlib
import itertools
import json

__all__ = ["export_jsonl", "read_jsonl", "chrome_trace",
           "write_chrome_trace", "critical_path", "format_report",
           "torch_profile"]


def export_jsonl(spans, path):
    """Write span dicts to ``path``, one JSON object per line."""
    with open(path, "w", encoding="utf-8") as f:
        for s in spans:
            f.write(json.dumps(s, sort_keys=True) + "\n")
    return len(list(spans))


def read_jsonl(path):
    out = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def chrome_trace(spans) -> dict:
    """Chrome trace-event JSON object for ``chrome://tracing``/Perfetto."""
    procs: dict[str, int] = {}
    threads: dict[tuple, int] = {}
    events = []
    for s in spans:
        proc = str(s.get("proc", "?"))
        pid = procs.setdefault(proc, len(procs) + 1)
        tkey = (proc, str(s.get("thread", "main")))
        tid = threads.setdefault(tkey, len(threads) + 1)
        events.append({
            "name": s["name"], "cat": s.get("cat", "host"), "ph": "X",
            "pid": pid, "tid": tid,
            "ts": s.get("t0", 0.0) * 1e6,
            "dur": max(s.get("dur", 0.0), 0.0) * 1e6,
            "args": dict(s.get("attrs") or {},
                         sid=s.get("sid"), parent=s.get("parent")),
        })
    meta = []
    for proc, pid in procs.items():
        meta.append({"name": "process_name", "ph": "M", "pid": pid,
                     "args": {"name": proc}})
    for (proc, tname), tid in threads.items():
        meta.append({"name": "thread_name", "ph": "M",
                     "pid": procs[proc], "tid": tid,
                     "args": {"name": tname}})
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def write_chrome_trace(spans, path):
    with open(path, "w", encoding="utf-8") as f:
        json.dump(chrome_trace(spans), f)


def _self_times(spans):
    """Per-span self time: duration minus the sum of direct children.

    Concurrent children (several parties inside one coordinator span)
    can sum past the parent's duration; self time clamps at zero.
    """
    child_sum: dict[str, float] = {}
    for s in spans:
        p = s.get("parent")
        if p is not None:
            child_sum[p] = child_sum.get(p, 0.0) + s.get("dur", 0.0)
    return {s["sid"]: max(0.0, s.get("dur", 0.0) - child_sum.get(s["sid"], 0.0))
            for s in spans}


def critical_path(spans) -> dict:
    """Attribute wall-clock to categories / processes / fit levels."""
    spans = list(spans)
    self_t = _self_times(spans)
    by_cat: dict[str, float] = {}
    by_proc: dict[str, float] = {}
    for s in spans:
        st = self_t.get(s["sid"], 0.0)
        by_cat[s.get("cat", "host")] = by_cat.get(s.get("cat", "host"), 0.0) + st
        proc = str(s.get("proc", "?"))
        by_proc[proc] = by_proc.get(proc, 0.0) + st

    # Per-level breakdown: spans tagged with a ``level`` attribute are
    # worker compute levels; comm time inside a level is the sum of its
    # comm descendants (direct children suffice: collectives open
    # directly under the level span).  A level-tagged span directly under
    # another (the frontier's live-count read inside ``tree.level``) is
    # part of its parent's time, not a level of its own.
    children: dict[str, list] = {}
    for s in spans:
        p = s.get("parent")
        if p is not None:
            children.setdefault(p, []).append(s)
    tagged = {s["sid"] for s in spans
              if (s.get("attrs") or {}).get("level") is not None}
    levels: dict[int, dict] = {}
    for s in spans:
        lvl = (s.get("attrs") or {}).get("level")
        if lvl is None or s.get("parent") in tagged:
            continue
        lv = levels.setdefault(int(lvl), {"compute_s": 0.0, "comm_s": 0.0,
                                          "spans": 0})
        comm = sum(c.get("dur", 0.0) for c in children.get(s["sid"], ())
                   if c.get("cat") == "comm")
        lv["comm_s"] += comm
        lv["compute_s"] += max(0.0, s.get("dur", 0.0) - comm)
        lv["spans"] += 1

    roots = [s for s in spans if s.get("parent") is None]
    wall = max((s.get("dur", 0.0) for s in roots), default=0.0)
    if spans and not wall:
        t0 = min(s.get("t0", 0.0) for s in spans)
        t1 = max(s.get("t0", 0.0) + s.get("dur", 0.0) for s in spans)
        wall = t1 - t0
    accounted = sum(by_cat.values())
    slowest = sorted(spans, key=lambda s: s.get("dur", 0.0), reverse=True)
    return {
        "n_spans": len(spans),
        "n_traces": len({s.get("tid") for s in spans}),
        "wall_s": wall,
        "by_category_s": dict(sorted(by_cat.items())),
        "by_process_s": dict(sorted(by_proc.items())),
        "levels": {k: levels[k] for k in sorted(levels)},
        "host_idle_s": max(0.0, wall - accounted),
        "slowest": [{"name": s["name"], "proc": str(s.get("proc", "?")),
                     "cat": s.get("cat", "host"),
                     "dur_s": s.get("dur", 0.0),
                     "attrs": dict(s.get("attrs") or {})}
                    for s in slowest[:10]],
    }


def format_report(spans, top: int = 10) -> str:
    """Human-readable critical-path summary of a span list."""
    cp = critical_path(spans)
    lines = []
    lines.append(f"spans: {cp['n_spans']}   traces: {cp['n_traces']}   "
                 f"wall: {cp['wall_s'] * 1e3:.1f} ms")
    lines.append("")
    lines.append("self-time by category (comm vs compute vs host):")
    for cat, t in cp["by_category_s"].items():
        pct = 100.0 * t / cp["wall_s"] if cp["wall_s"] else 0.0
        lines.append(f"  {cat:<10} {t * 1e3:10.1f} ms  {pct:5.1f}%")
    lines.append(f"  {'(idle)':<10} {cp['host_idle_s'] * 1e3:10.1f} ms")
    lines.append("")
    lines.append("self-time by process:")
    for proc, t in cp["by_process_s"].items():
        lines.append(f"  {proc:<14} {t * 1e3:10.1f} ms")
    if cp["levels"]:
        lines.append("")
        lines.append("per-level (summed across parties/trees):")
        lines.append(f"  {'level':>5}  {'compute ms':>10}  {'comm ms':>10}"
                     f"  {'spans':>5}")
        for lvl, d in cp["levels"].items():
            lines.append(f"  {lvl:>5}  {d['compute_s'] * 1e3:>10.1f}"
                         f"  {d['comm_s'] * 1e3:>10.1f}  {d['spans']:>5}")
    lines.append("")
    lines.append(f"slowest spans (top {min(top, len(cp['slowest']))}):")
    for s in cp["slowest"][:top]:
        attrs = " ".join(f"{k}={v}" for k, v in s["attrs"].items())
        lines.append(f"  {s['dur_s'] * 1e3:9.1f} ms  {s['proc']:<12} "
                     f"[{s['cat']}] {s['name']}" + (f"  {attrs}" if attrs else ""))
    return "\n".join(lines)


_TRACE_IDS = itertools.count(1)


@contextlib.contextmanager
def torch_profile(logdir):
    """Opt-in ``torch.profiler`` trace around a block; no-op if logdir falsy.

    The trace lands in ``logdir`` as ``trace_<pid>_<n>.json`` (Chrome
    trace-event format; ``n`` counts the traces this process wrote)."""
    if not logdir:
        yield
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(str(logdir), exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        str(logdir), f"trace_{os.getpid()}_{next(_TRACE_IDS)}.json"))
