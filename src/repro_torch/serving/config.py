"""ServeConfig — the one value object describing how a model is served.

``Federation.serve`` historically grew one keyword per serving knob
(buckets, compact, max_inflight, autotune_buckets, ...) and the server
cache keyed on an ad-hoc tuple of them.  This dataclass is the single
consolidated description: it is frozen and hashable, so the *same object*
is both the call's configuration and the session's server-cache key — a
knob that matters for caching cannot be forgotten in the key, and a knob
that doesn't (``traffic`` is an input, not a configuration) stays out.

Legacy keyword calls keep working through :func:`adapt_legacy_kwargs`,
which emits one DeprecationWarning and builds the equivalent ServeConfig.
"""
from __future__ import annotations

import dataclasses
import warnings

#: serve() keywords that moved onto ServeConfig; the adapter lifts them.
LEGACY_SERVE_KEYS = ("buckets", "compact", "max_inflight",
                     "autotune_buckets", "allow_degraded")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """How a serving engine is set up (not *what* it serves).

    Attributes:
      buckets: ascending batch-row buckets, or None for the engine default
        (requests pad to the smallest fitting bucket; oversized requests
        run in waves of the largest).
      compact: serve through the leaf-compacted kernel (LeafTable).
      max_inflight: async wave-ring depth (1 = synchronous waves).
      autotune_buckets: derive the bucket set from observed traffic
        (serving/autotune.py) instead of the warm-start guess.
      allow_degraded: on a distributed substrate, answer from the trees
        whose split paths avoid a dead party's features instead of failing
        the wave (flagged ``degraded`` in wave_stats).  In-process
        substrates have no partial-failure mode; the flag is inert there.
    """

    buckets: tuple[int, ...] | None = None
    compact: bool = True
    max_inflight: int = 1
    autotune_buckets: bool = False
    allow_degraded: bool = False

    def __post_init__(self) -> None:
        if self.buckets is not None:
            object.__setattr__(self, "buckets",
                               tuple(int(b) for b in self.buckets))
        if int(self.max_inflight) < 1:
            raise ValueError(
                f"max_inflight must be >= 1, got {self.max_inflight}")
        object.__setattr__(self, "max_inflight", int(self.max_inflight))

    def resolved_buckets(self, default: tuple[int, ...]) -> tuple[int, ...]:
        return self.buckets if self.buckets is not None else tuple(default)


def adapt_legacy_kwargs(config: ServeConfig | None, kw: dict) -> ServeConfig:
    """Lift pre-ServeConfig ``serve(...)`` keywords out of ``kw`` (mutating
    it) into a ServeConfig.  Mixing both spellings is rejected — silently
    preferring one would drop the other's knobs."""
    legacy = {k: kw.pop(k) for k in LEGACY_SERVE_KEYS if k in kw}
    if not legacy:
        return config if config is not None else ServeConfig()
    if config is not None:
        raise ValueError(
            f"pass serving knobs through ServeConfig OR the legacy "
            f"keywords, not both (got config= and {sorted(legacy)})")
    warnings.warn(
        f"Federation.serve({', '.join(sorted(legacy))}=...) keywords are "
        f"deprecated: pass serve(model, ServeConfig(...)) instead",
        DeprecationWarning, stacklevel=3)
    return ServeConfig(**legacy)
