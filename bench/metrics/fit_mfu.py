"""fit_mfu: the least time of one fit at the H100's published HBM rate,
over the measured fit time, in percent.  The fit does no arithmetic worth
counting, so its bytes bound it: the algorithm's own bytes
(``bench/roofline.py``), counted over the trees the window's fits grew as
the reference routed their rows."""
from bench import roofline


def read(ctx):
    trees = ctx.counts.get("trees")
    fit_s = ctx.e2e.get("fit_s")
    if not trees or not fit_s:
        return None
    b = roofline.config_fit_bytes(trees, ctx.config)
    return 100.0 * roofline.least_seconds(b["bytes"]) / fit_s
