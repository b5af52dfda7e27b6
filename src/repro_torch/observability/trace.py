"""Hierarchical spans with explicit cross-process context propagation.

Span model
----------
A *span* is a named, timed interval with a trace id, a span id, and an
optional parent span id.  Spans nest through a thread-local stack: the
innermost open span on the current thread is the parent of the next one
opened.  Asynchronous spans (``begin``/``finish``: a wave in flight, a
request waiting) take the innermost open span as their parent but never
enter the stack, so two that overlap are siblings and host work done
while one is open parents under the host span around it.  A *trace* is
the set of spans sharing one trace id — one
distributed fit yields one trace covering the coordinator's per-level
rounds, each party worker's op execution, retry/backoff sleeps, and
circuit-breaker flips.

Cross-process propagation is explicit: ``current_context()`` returns the
``{"tid", "sid"}`` pair of the innermost open span (or ``None``), the
transport attaches it to outgoing frames under the ``_trace`` key, and a
worker wraps message handling in ``TRACER.attach(ctx)`` so its spans
parent under the coordinator's span even though they live in another OS
process.  Span start times are wall-clock epoch seconds (comparable
across processes); durations come from ``perf_counter`` deltas.

One clock with the device trace: while the tracer is enabled and a
``torch.profiler`` session is running, every context-manager span also
opens a profiler range of its name, so the span is a host event of the
same trace as the kernels it launched, on the profiler's clock (epoch
nanoseconds, the clock of ``t0``).  Asynchronous spans are not mirrored:
they are not host activity.

Zero cost when disabled: ``span()`` returns a shared no-op singleton and
``current_context()`` returns ``None``, so no allocation happens, no
span ids are minted, and — critically — no ``_trace`` key is ever added
to wire messages (disabled-path traffic is byte-identical to
uninstrumented code).

Privacy: span names/attributes are metadata only.  Attribute values are
restricted to scalars (str/int/float/bool/None) and short tuples of
scalars; anything array-like raises ``TypeError``, so raw data cannot ride
along a span.

This module imports only the stdlib, so every layer of the port — the
transport included, once it lands — can depend on it; ``torch`` is
imported on the enabled path alone, to mirror spans into a running
profiler.  It is the JAX package's ``repro.observability.trace``, copied,
with the mirror and asynchronous spans kept off the stack.
"""
from __future__ import annotations

import collections
import itertools
import os
import threading
import time

__all__ = ["Tracer", "TRACER", "current_context"]

_MAX_SPANS = 65536
_MAX_ATTR_TUPLE = 32
_SCALARS = (str, int, float, bool, type(None))


def _check_attrs(attrs):
    """Validate that every attribute value is plain metadata.

    Raises TypeError on arrays / dicts / arbitrary objects so raw data
    cannot ride along a span even if the linter is bypassed at runtime.
    """
    for k, v in attrs.items():
        if isinstance(v, _SCALARS):
            continue
        if isinstance(v, (tuple, list)) and len(v) <= _MAX_ATTR_TUPLE and all(
                isinstance(e, _SCALARS) for e in v):
            attrs[k] = tuple(v)
            continue
        raise TypeError(
            f"span attribute {k!r} must be a scalar or short tuple of "
            f"scalars, got {type(v).__name__} (metadata-only payloads)")
    return attrs


class _NoopSpan:
    """Shared do-nothing span handle returned while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


_NOOP = _NoopSpan()


def _profiler_range(name):
    """A ``torch.profiler`` range named ``name``, entered, when a profiler
    session is running on this process; None otherwise."""
    import torch
    if not torch.autograd._profiler_enabled():
        return None
    rf = torch.autograd.profiler.record_function(name)
    rf.__enter__()
    return rf


class _SpanHandle:
    """An open span; context manager that records itself on exit."""

    __slots__ = ("_tracer", "name", "category", "tid", "sid", "parent",
                 "t0", "_pc0", "attrs", "_thread", "_range")

    def __init__(self, tracer, name, category, tid, sid, parent, attrs,
                 mirror):
        self._tracer = tracer
        self.name = name
        self.category = category
        self.tid = tid
        self.sid = sid
        self.parent = parent
        self.attrs = attrs
        # the mirrored profiler range opens first, so that ``t0`` is its start
        self._range = _profiler_range(name) if mirror else None
        self.t0 = time.time()
        self._pc0 = time.perf_counter()
        self._thread = threading.current_thread().name

    def set(self, **attrs):
        self.attrs.update(_check_attrs(attrs))
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._tracer._finish(self)
        if self._range is not None:
            self._range.__exit__(None, None, None)
        return False


class Tracer:
    """Process-local span recorder with a bounded buffer.

    Enabled via the ``REPRO_TRACE=1`` environment variable or
    ``enable()``.  Even when disabled, ``attach(ctx)`` with a non-None
    remote context arms recording on that thread — a worker process that
    never saw the env var still records spans for traced coordinator
    messages.
    """

    def __init__(self, enabled: bool | None = None, process: str | None = None):
        if enabled is None:
            enabled = os.environ.get("REPRO_TRACE", "") == "1"
        self._enabled = bool(enabled)
        self.process = process if process is not None else f"pid{os.getpid()}"
        self._ids = itertools.count(1)
        self._buf = collections.deque(maxlen=_MAX_SPANS)
        self._local = threading.local()

    # ------------------------------------------------------------ state
    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self):
        self._enabled = True

    def disable(self):
        self._enabled = False

    def reset(self):
        """Drop buffered spans and this thread's context (for tests)."""
        self._buf.clear()
        self._local.stack = []
        self._local.remote = 0

    def _stack(self):
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _active(self) -> bool:
        return self._enabled or getattr(self._local, "remote", 0) > 0

    def _next_sid(self) -> str:
        return f"{self.process}/{next(self._ids)}"

    # ---------------------------------------------------------- context
    def current_context(self):
        """``{"tid", "sid"}`` of the innermost open span, or ``None``."""
        st = getattr(self._local, "stack", None)
        if not st:
            return None
        tid, sid = st[-1]
        return {"tid": tid, "sid": sid}

    def attach(self, ctx):
        """Context manager parenting this thread's spans under a remote
        context dict (``{"tid", "sid"}``).  ``ctx=None`` is a no-op."""
        return _Attach(self, ctx)

    # ------------------------------------------------------------ spans
    def span(self, name: str, category: str = "host", **attrs):
        """Open a span as a context manager; no-op singleton when off.
        Under a running profiler it also opens a profiler range of the same
        name, closed with the span."""
        if not self._active():
            return _NOOP
        return self._begin(name, category, attrs, push=True)

    def begin(self, name: str, category: str = "host", **attrs):
        """Manually open an asynchronous span (pair with ``finish``); None
        when off.

        For spans whose open/close straddle function boundaries, e.g. a
        serving wave opened at dispatch and closed at collect.  Its parent
        is the innermost open span; it is never a parent itself, and it is
        not mirrored into a profiler.
        """
        if not self._active():
            return None
        return self._begin(name, category, attrs, push=False)

    def finish(self, handle):
        if handle is not None and handle is not _NOOP:
            self._finish(handle)

    def event(self, name: str, category: str = "host", **attrs):
        """Record a zero-duration instant span."""
        if not self._active():
            return
        self._finish(self._begin(name, category, attrs, push=False))

    def _begin(self, name, category, attrs, *, push):
        st = self._stack()
        if st:
            tid, parent = st[-1]
        else:
            tid, parent = f"t{self._next_sid()}", None
        sid = self._next_sid()
        h = _SpanHandle(self, name, category, tid, sid, parent,
                        _check_attrs(attrs), mirror=push)
        if push:
            st.append((tid, sid))
        return h

    def _finish(self, h):
        dur = time.perf_counter() - h._pc0
        st = self._stack()
        # Pop back to (and including) this span if it is on the stack (a
        # context-manager span; asynchronous ones never are), closing any
        # span left open inside it.
        for i in range(len(st) - 1, -1, -1):
            if st[i][1] == h.sid:
                del st[i:]
                break
        self._buf.append({
            "name": h.name, "cat": h.category, "tid": h.tid, "sid": h.sid,
            "parent": h.parent, "t0": h.t0, "dur": dur,
            "proc": self.process, "thread": h._thread,
            "attrs": dict(h.attrs),
        })

    # ----------------------------------------------------------- export
    def adopt(self, span_dict: dict):
        """Append a span recorded by another process (telemetry rollup)."""
        if isinstance(span_dict, dict) and "name" in span_dict:
            self._buf.append(dict(span_dict))

    def spans(self) -> list[dict]:
        """Snapshot of buffered spans (oldest first), without clearing."""
        return list(self._buf)

    def drain(self) -> list[dict]:
        """Pop and return all buffered spans (oldest first)."""
        out = []
        while True:
            try:
                out.append(self._buf.popleft())
            except IndexError:
                return out


class _Attach:
    __slots__ = ("_tracer", "_ctx", "_pushed")

    def __init__(self, tracer, ctx):
        self._tracer = tracer
        self._ctx = ctx
        self._pushed = False

    def __enter__(self):
        ctx = self._ctx
        if ctx and "tid" in ctx and "sid" in ctx:
            self._tracer._stack().append((str(ctx["tid"]), str(ctx["sid"])))
            self._tracer._local.remote = getattr(
                self._tracer._local, "remote", 0) + 1
            self._pushed = True
        return self

    def __exit__(self, *exc):
        if self._pushed:
            st = self._tracer._stack()
            if st:
                st.pop()
            self._tracer._local.remote = max(
                0, getattr(self._tracer._local, "remote", 1) - 1)
        return False


#: Process-wide tracer.  Workers re-tag ``TRACER.process`` on startup.
TRACER = Tracer()


def current_context():
    """Module-level convenience for the transport layer."""
    return TRACER.current_context()
