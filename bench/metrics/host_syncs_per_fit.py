"""host_syncs_per_fit: reads of a device value by the host in the fit path
(the program's ``forest.host_syncs`` counter: the frontier's live count,
one a compacted level a tree), per fit of the span sub-window
(``bench/spans.py``)."""
from bench import spans


def read(ctx):
    if ctx.driver_kind != "fit":
        return None
    w = spans.window(ctx)
    if not w or not w["fits"] or w["counters"]["forest.host_syncs"] is None:
        return None
    return w["counters"]["forest.host_syncs"] / w["fits"]
