"""device_idle.serve: the share of the traced serving sub-window in which
no operation ran on the device, in percent."""


def read(ctx):
    prof = ctx.profile
    if ctx.driver_kind != "serve" or prof is None or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
