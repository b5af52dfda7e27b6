"""queue_wait_p95_ms: 95th percentile, in milliseconds, of the program's
``queue.wait`` spans (a request's submit to the dispatch of the wave that
carries its first rows) over the span sub-window (``bench/spans.py``)."""
import numpy as np

from bench import spans


def read(ctx):
    if ctx.driver_kind != "serve":
        return None
    w = spans.window(ctx)
    durs = spans.durations(w, "queue.wait") if w else []
    if not durs:
        return None
    return float(np.percentile(durs, 95)) * 1e3
