"""ingest_s: host seconds of ``Federation.ingest(x, y)`` in set-up —
quantile binning and the vertical partition of the raw training rows."""


def read(ctx):
    return ctx.spans.get("ingest_s")
