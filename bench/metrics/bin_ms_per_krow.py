"""bin_ms_per_krow: host milliseconds in the pump's ``queue.bin`` spans
(binning a raw request's rows as they join a wave) per 1,000 rows binned,
over the span sub-window (``bench/spans.py``)."""
from bench import spans


def read(ctx):
    if ctx.driver_kind != "serve":
        return None
    w = spans.window(ctx)
    bins = [s for s in w["spans"] if s["name"] == "queue.bin"] if w else []
    rows = sum(s["attrs"].get("rows", 0) for s in bins)
    if not rows:
        return None
    return 1e3 * sum(s["dur"] for s in bins) / (rows / 1e3)
