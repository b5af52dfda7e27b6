"""staged_mb_per_fit: megabytes (1e6 bytes) of host arrays a fit makes
into device operands (the program's ``forest.staged_bytes`` counter: the
binned table, labels, bootstrap weights, feature draws), per fit of the
span sub-window (``bench/spans.py``)."""
from bench import spans


def read(ctx):
    if ctx.driver_kind != "fit":
        return None
    w = spans.window(ctx)
    if not w or not w["fits"] or w["counters"]["forest.staged_bytes"] is None:
        return None
    return w["counters"]["forest.staged_bytes"] / w["fits"] / 1e6
