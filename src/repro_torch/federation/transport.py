"""Wire transport for the party-per-process substrate — for now, its
errors alone.

The JAX package's ``repro.federation.transport`` frames protocol messages
over sockets (``Channel``, retries, circuit breakers) for the
party-per-process substrate.  That transport, and the substrate behind
it, are not ported yet.  What the port needs today is the error type the
serving layer catches: :class:`PartyUnavailableError`, with the
``parties`` it is attributed to (``serving/fleet.py`` drains a cell on
it, and degraded serving picks its surviving trees by it).
"""
from __future__ import annotations


class TransportError(RuntimeError):
    """Base class for wire-level failures."""


class PartyUnavailableError(TransportError):
    """One or more parties could not complete a protocol round.

    ``parties`` holds the party indices the failure is attributed to —
    the serving layer uses them to pick the surviving-tree degraded path.
    """

    def __init__(self, message: str, parties=()):  # noqa: D107
        super().__init__(message)
        self.parties = tuple(parties)
