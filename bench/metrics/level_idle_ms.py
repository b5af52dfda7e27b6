"""level_idle_ms: device-idle milliseconds whose innermost program span is
``tree.level`` (the level loop's own host work between launches, not a
child span such as the live-count read), per ``tree.level`` span of the
span sub-window (``bench/spans.py``).  None without a device trace."""
from bench import spans


def read(ctx):
    if ctx.driver_kind != "fit":
        return None
    w = spans.window(ctx)
    n = len(spans.durations(w, "tree.level")) if w else 0
    if not n or w["busy_s"] <= 0:
        return None
    return 1e3 * w["idle"].get("tree.level", 0.0) / n
