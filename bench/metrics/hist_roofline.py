"""hist_roofline: the least time of the traced fits' histograms at the
H100's published HBM rate (each searched row's bins, node id and stats
read once, each searched node's histogram written once: no routing), over
the histogram kernel's device time in the profile, in percent."""
from bench import roofline
from bench import trace

KERNEL = "hist_kernel"      # the kernel's name as the profiler prints it


def read(ctx):
    trees = ctx.counts.get("trees")
    prof = ctx.profile
    fits = ctx.counters.get("traced_fits")
    if not trees or prof is None or not fits:
        return None
    secs, count = trace.kernel_seconds(prof, KERNEL)
    if count == 0 or secs <= 0:
        return None
    b = roofline.config_fit_bytes(trees, ctx.config)
    return 100.0 * roofline.least_seconds(fits * b["hist_bytes"]) / secs
