"""Execution substrates: where the federated protocol runs.

The protocol bodies (core/tree.py, core/prediction.py) take the party axis
as an explicit leading tensor dimension, so a substrate decides only how the
party-stacked arguments reach them:

  * ``SimulatedSubstrate`` — all M parties in this process, on one device.

The JAX package's sharded and party-per-process substrates are not ported
yet.
"""
from __future__ import annotations

from typing import Any, Callable


class SimulatedSubstrate:
    """M parties on one device — semantically the distributed run."""

    name = "simulated"

    def program(self, fn: Callable, n_party: int, n_shared: int) -> Callable:
        """Callable over (party_args..., shared_args...).  Party args (a
        tensor, or a tuple of tensors such as a PartyTree) carry the leading
        party dimension M, which they must agree on."""
        def run(*args):
            party = args[:n_party]
            sizes = {int((a[0] if isinstance(a, tuple) else a).shape[0])
                     for a in party}
            if len(sizes) != 1:
                raise ValueError(f"party arguments disagree on the party "
                                 f"count: leading sizes {sorted(sizes)}")
            return fn(*party, *args[n_party:n_party + n_shared])
        return run


SUBSTRATES: dict[str, Callable[[], Any]] = {"simulated": SimulatedSubstrate}


def default_substrate(sub: Any = None) -> Any:
    """The substrate an estimator runs on when none was injected."""
    return sub if sub is not None else SimulatedSubstrate()


def resolve_substrate(spec: Any) -> Any:
    """A registered substrate name or an already-built substrate."""
    if isinstance(spec, str):
        factory = SUBSTRATES.get(spec)
        if factory is None:
            raise ValueError(f"unknown substrate {spec!r} "
                             f"(registered: {sorted(SUBSTRATES)})")
        return factory()
    if callable(getattr(spec, "program", None)):
        return spec
    raise ValueError(f"unknown substrate {spec!r} "
                     f"(registered: {sorted(SUBSTRATES)}, or pass a substrate)")
