"""dispatch_ms_per_wave: host milliseconds of the program's
``serve.dispatch`` span (pad, stage into the pinned slot, replay the
bucket's graph, record the event) per wave of the span sub-window
(``bench/spans.py``)."""
from bench import spans


def read(ctx):
    if ctx.driver_kind != "serve":
        return None
    w = spans.window(ctx)
    durs = spans.durations(w, "serve.dispatch") if w else []
    if not durs:
        return None
    return 1e3 * sum(durs) / len(durs)
