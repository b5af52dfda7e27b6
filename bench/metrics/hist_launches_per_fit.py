"""hist_launches_per_fit: the histogram kernel's launches
(``histogram_cuda.launches``, a counter that repeats exactly) over the
traced fits, divided by the fits."""


def read(ctx):
    return ctx.counters.get("hist_launches_per_fit")
