"""wave_rows_mean: rows a wave over the window (the ``serving.rows`` and
``serving.waves`` counters' deltas): how far the queue coalesces."""


def read(ctx):
    waves = ctx.counters.get("waves")
    if not waves:
        return None
    return ctx.counters["rows"] / waves
