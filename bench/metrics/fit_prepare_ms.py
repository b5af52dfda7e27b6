"""fit_prepare_ms: host milliseconds a fit spends in the program's
``fit.prepare`` span (label coding, the master's bootstrap and feature
draws, staging the operands on the device: everything before the fit
program launches), per fit of the span sub-window (``bench/spans.py``)."""
from bench import spans


def read(ctx):
    if ctx.driver_kind != "fit":
        return None
    w = spans.window(ctx)
    durs = spans.durations(w, "fit.prepare") if w else []
    if not durs:
        return None
    return 1e3 * sum(durs) / len(durs)
