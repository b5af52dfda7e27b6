"""device_idle.fit: the share of the traced fits' window in which no
operation ran on the device (1 - union of device intervals / window), in
percent."""


def read(ctx):
    prof = ctx.profile
    if ctx.driver_kind != "fit" or prof is None or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
