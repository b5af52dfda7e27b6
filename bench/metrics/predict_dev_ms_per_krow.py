"""predict_dev_ms_per_krow: device-busy milliseconds of the traced serving
sub-window (its kernels and graph replays) per thousand rows served."""


def read(ctx):
    prof = ctx.profile
    rows = ctx.counters.get("traced_rows")
    if ctx.driver_kind != "serve" or prof is None or not rows:
        return None
    if prof["busy_s"] <= 0:
        return None
    return prof["busy_s"] * 1e3 / (rows / 1e3)
