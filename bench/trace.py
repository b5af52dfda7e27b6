"""Profile a sub-window with ``torch.profiler`` and reduce its trace.

The device is busy over the union of its operations' intervals (kernels,
copies, sets); the traced window is the host seconds around the profiled
work, which ends in a device sync.  Idle gaps between device operations
are attributed to what the host was doing at the gap's middle: the
innermost host operation then running (an ``aten`` op, a CUDA runtime
call), or ``python`` where none was.
"""
from __future__ import annotations

import bisect
import time

import torch

GAP_FLOOR_NS = 2000         # shorter gaps are the launch pipeline's own


def _union(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def profile(fn, device) -> tuple[object, dict]:
    """Run ``fn()`` under the profiler (PyTorch's Kineto session, read as
    its raw events: building the profiler's Python event tree would take
    longer than the window); returns ``fn``'s result and the reduction:
    ``busy_s``, ``window_s``, ``device_ops`` (name -> [seconds, count]),
    ``idle_gaps`` (host activity -> seconds)."""
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
        out = fn()
        if cuda:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    finally:
        events = _disable_profiler().events()
    return out, reduce_events(events, window_s)


def reduce_events(events, window_s: float) -> dict:
    """Reduce raw profiler events (``name()``, ``device_type()``,
    ``start_ns()``, ``end_ns()``, ``start_thread_id()``)."""
    dev_type = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in events:
        (dev if e.device_type() == dev_type else host).append(e)
    spans = sorted((e.start_ns(), e.end_ns()) for e in dev)
    ops: dict[str, list] = {}
    for e in dev:
        rec = ops.setdefault(e.name(), [0.0, 0])
        rec[0] += (e.end_ns() - e.start_ns()) / 1e9
        rec[1] += 1
    gaps = []
    end = None
    for a, b in spans:
        if end is not None and a - end > GAP_FLOOR_NS:
            gaps.append((end, a))
        end = b if end is None else max(end, b)
    host_spans = [(e.start_ns(), e.end_ns(), e.name(), e.start_thread_id())
                  for e in host]
    return {"busy_s": _union(spans) / 1e9, "window_s": window_s,
            "device_ops": ops, "idle_gaps": _attribute(gaps, host_spans)}


def _attribute(gaps, host) -> dict[str, float]:
    """Seconds of idle device gaps by the innermost host event active at
    each gap's middle (events of one thread nest)."""
    by_thread: dict[int, list] = {}
    for s, e, name, thread in host:
        by_thread.setdefault(thread, []).append((s, e, name))
    # the thread that issued the work: the one with the most events
    evs = max(by_thread.values(), key=len) if by_thread else []
    evs.sort(key=lambda t: (t[0], -t[1]))
    starts = [s for s, _, _ in evs]
    out: dict[str, float] = {}
    stack: list = []
    i = 0
    for a, b in sorted(gaps):
        mid = 0.5 * (a + b)
        j = bisect.bisect_right(starts, mid)
        while i < j:
            s, e, n = evs[i]
            while stack and stack[-1][1] <= s:
                stack.pop()
            stack.append((s, e, n))
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        name = stack[-1][2] if stack else "python"
        out[name] = out.get(name, 0.0) + (b - a) / 1e9
    return out


def breakdown(red: dict, top: int = 10) -> dict:
    """The result line's ``breakdown``: the device operations that took
    most time and the longest idle gaps by host activity, each [name,
    seconds], at most ``top`` each."""
    ops = sorted(((n[:96], v[0]) for n, v in red["device_ops"].items()),
                 key=lambda t: -t[1])[:top]
    gaps = sorted(((n[:96], v) for n, v in red["idle_gaps"].items()),
                  key=lambda t: -t[1])[:top]
    return {"device_ops": [list(t) for t in ops],
            "idle_gaps": [list(t) for t in gaps]}


def kernel_seconds(red: dict, match: str) -> tuple[float, int]:
    """Device seconds and count of the operations whose name holds
    ``match``."""
    secs, count = 0.0, 0
    for name, (s, c) in red["device_ops"].items():
        if match in name:
            secs += s
            count += c
    return secs, count
