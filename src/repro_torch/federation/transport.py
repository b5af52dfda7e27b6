"""Wire transport for the party-per-process substrate.

The paper's deployed system runs each regional party as its own service and
moves only protocol messages — hashed IDs, binned values, masked statistics —
across the network.  This module is that wire layer, the JAX package's
``repro.federation.transport`` carried over (it is NumPy-only there too):

  * **framing** — every message is a 4-byte big-endian length prefix followed
    by a msgpack payload.  Arrays ride as ``{dtype, shape, raw bytes}`` (no
    pickle on the wire): NumPy arrays as they are, tensors through
    ``.detach().cpu().numpy()``, so a frame for the same values is the same
    bytes in both packages.  NamedTuple pytrees (PartyTree) register a codec
    via :func:`register_namedtuple`.
  * **Channel** — a connected socket with ``send``/``recv`` of framed
    messages and a per-round-trip timeout budget: a peer that does not
    produce a complete frame within the budget raises :class:`PartyTimeout`,
    a closed peer raises :class:`PartyDead`.
  * **RetryPolicy** — jittered exponential backoff between attempts; the
    jitter stream is seeded so fault-injection tests observe deterministic
    sleep schedules (the sleeper is injectable for the same reason).
  * **CircuitBreaker** — per-party consecutive-failure breaker with an
    observer seam: after ``threshold`` consecutive failures the circuit
    opens and further calls fail fast with :class:`CircuitOpenError`.  A
    recorded success (or ``reset``) closes it; with an optional
    ``cooldown_s`` an open circuit half-opens after the cooldown and lets
    probe calls through.  Every state flip is counted in the telemetry
    registry, traced as an instant span, and reported to the
    ``on_transition`` callback.

Two policy hooks ride along.  The privacy egress guard
(``repro_torch.analysis.runtime``, NumPy-only): when
``REPRO_EGRESS_GUARD=1`` every outgoing payload is checked against the
raw-array taint registry before encoding, so a raw feature/ID/label buffer
— as an ndarray, a view, or a CPU tensor over it — can never be framed:
the runtime twin of the static ``python -m repro_torch.analysis`` pass.
Observability (``repro_torch.observability``, stdlib-only): every channel
counts its frame bytes (``transport.bytes_sent`` /
``transport.bytes_received``); when tracing is active, ``Channel.send``
stamps the current span context onto the frame under the ``_trace`` key
(receivers that don't trace ignore it; with tracing disabled the key is
never added, so wire bytes are identical to uninstrumented code).
"""
from __future__ import annotations

import dataclasses
import socket
import struct
import time
from typing import Callable

import msgpack
import numpy as np
import torch

from repro_torch.analysis import runtime as egress_guard
from repro_torch.observability import registry as telemetry
from repro_torch.observability import trace as tracing

_LEN = struct.Struct(">I")
_MAX_FRAME = 1 << 31  # sanity bound; a larger frame means a corrupt stream


# --------------------------------------------------------------------- errors
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


class PartyTimeout(PartyUnavailableError):
    """A party did not answer within the round-trip timeout budget."""


class PartyDead(PartyUnavailableError):
    """A party's connection is gone (process exit, socket close)."""


class CircuitOpenError(PartyUnavailableError):
    """A party's circuit breaker is open: failing fast without dispatch."""


class ProtocolError(TransportError):
    """A peer answered with an out-of-protocol message."""


# ---------------------------------------------------------------------- codec
_ND = "__nd__"
_NT = "__nt__"
_NAMEDTUPLES: dict[str, type] = {}


def register_namedtuple(cls: type) -> type:
    """Allow a NamedTuple type (e.g. core.tree.PartyTree) on the wire: it is
    encoded as its field dict plus the type name, and decoded back through
    this registry — the receiving process must register the same type."""
    _NAMEDTUPLES[cls.__name__] = cls
    return cls


def _default(obj):
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):  # NamedTuple
        name = type(obj).__name__
        if name not in _NAMEDTUPLES:
            raise TypeError(f"NamedTuple {name} is not wire-registered "
                            f"(transport.register_namedtuple)")
        return {_NT: name, "f": {k: v for k, v in obj._asdict().items()}}
    if isinstance(obj, np.generic):
        return obj.item()
    if torch.is_tensor(obj):
        obj = obj.detach().cpu().numpy()
    a = np.asarray(obj)
    if a.dtype == object:
        raise TypeError(f"cannot encode {type(obj).__name__} for the wire")
    return {_ND: True, "d": a.dtype.str, "s": list(a.shape),
            "b": a.tobytes()}


def _object_hook(obj: dict):
    if _ND in obj:
        a = np.frombuffer(obj["b"], dtype=np.dtype(obj["d"]))
        return a.reshape(obj["s"]).copy()
    if _NT in obj:
        cls = _NAMEDTUPLES.get(obj[_NT])
        if cls is None:
            raise ProtocolError(f"unregistered NamedTuple {obj[_NT]!r} on "
                                f"the wire")
        return cls(**obj["f"])
    return obj


def _encode(obj):
    """Pre-walk for types msgpack would serialize natively but wrongly:
    a NamedTuple IS a tuple, so the ``default`` hook never sees it."""
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        name = type(obj).__name__
        if name not in _NAMEDTUPLES:
            raise TypeError(f"NamedTuple {name} is not wire-registered "
                            f"(transport.register_namedtuple)")
        return {_NT: name, "f": {k: _encode(v)
                                 for k, v in obj._asdict().items()}}
    if isinstance(obj, (list, tuple)):
        return [_encode(v) for v in obj]
    if isinstance(obj, dict):
        return {k: _encode(v) for k, v in obj.items()}
    return obj


def pack(msg: dict) -> bytes:
    body = msgpack.packb(_encode(msg), default=_default, use_bin_type=True)
    return _LEN.pack(len(body)) + body


def unpack(body: bytes) -> dict:
    return msgpack.unpackb(body, object_hook=_object_hook, raw=False,
                           strict_map_key=False)


# -------------------------------------------------------------------- channel
class Channel:
    """A connected message stream with per-round-trip timeout budgets."""

    def __init__(self, sock: socket.socket, *, party: int | None = None):
        self.sock = sock
        self.party = party            # peer's party index, when known
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._rbuf = bytearray()
        # frame bytes each way, this process's channels together
        self._m_sent = telemetry.REGISTRY.counter("transport.bytes_sent")
        self._m_recv = telemetry.REGISTRY.counter("transport.bytes_received")

    def send(self, msg: dict) -> None:
        ctx = tracing.current_context()
        if ctx is not None and "_trace" not in msg:
            msg = dict(msg, _trace=ctx)
        egress_guard.check_egress(
            msg, context=f"Channel.send(party={self.party})")
        frame = pack(msg)
        try:
            self.sock.sendall(frame)
        except (OSError, ValueError) as e:
            raise PartyDead(f"party {self.party}: send failed ({e})",
                            parties=self._who()) from e
        self._m_sent.inc(len(frame))

    def recv(self, timeout: float | None = None) -> dict:
        """Receive one framed message; ``timeout`` bounds the WHOLE frame."""
        deadline = None if timeout is None else time.monotonic() + timeout
        header = self._read(4, deadline)
        (n,) = _LEN.unpack(header)
        if n > _MAX_FRAME:
            raise ProtocolError(f"party {self.party}: oversized frame ({n})")
        body = self._read(n, deadline)
        self._m_recv.inc(4 + n)
        return unpack(body)

    def _read(self, n: int, deadline: float | None) -> bytes:
        buf = self._rbuf             # partial frames stay here on a timeout
        while len(buf) < n:
            if deadline is None:
                self.sock.settimeout(None)
            else:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise PartyTimeout(
                        f"party {self.party}: no reply within the "
                        f"round-trip budget", parties=self._who())
                self.sock.settimeout(left)
            try:
                chunk = self.sock.recv(1 << 20)
            except (socket.timeout, TimeoutError) as e:
                raise PartyTimeout(
                    f"party {self.party}: no reply within the round-trip "
                    f"budget", parties=self._who()) from e
            except OSError as e:
                raise PartyDead(f"party {self.party}: connection lost ({e})",
                                parties=self._who()) from e
            if not chunk:
                raise PartyDead(f"party {self.party}: connection closed",
                                parties=self._who())
            buf += chunk
        out = bytes(buf[:n])
        del buf[:n]
        return out

    def _who(self) -> tuple:
        return () if self.party is None else (self.party,)

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


def connect(host: str, port: int, *, timeout: float = 10.0,
            retry: "RetryPolicy | None" = None) -> Channel:
    """Dial a coordinator/worker endpoint, retrying per the policy."""
    policy = retry or RetryPolicy()
    last: Exception | None = None
    for attempt in range(policy.attempts):
        try:
            sock = socket.create_connection((host, port), timeout=timeout)
            sock.settimeout(None)
            return Channel(sock)
        except OSError as e:
            last = e
            if attempt + 1 < policy.attempts:
                policy.backoff(attempt)
    raise PartyDead(f"connect to {host}:{port} failed after "
                    f"{policy.attempts} attempts ({last})")


# ------------------------------------------------------------ fault tolerance
@dataclasses.dataclass
class RetryPolicy:
    """Jittered exponential backoff: delay_k = base * mult^k * (1 + j*u_k).

    ``seed`` makes the jitter stream deterministic and ``sleeper`` is
    injectable, so fault-injection tests can assert the exact backoff
    schedule (``slept`` records every delay handed to the sleeper).
    """

    attempts: int = 3
    base: float = 0.05
    mult: float = 2.0
    jitter: float = 0.5
    max_delay: float = 5.0
    seed: int = 0
    sleeper: Callable[[float], None] = time.sleep

    def __post_init__(self) -> None:
        if self.attempts < 1:
            raise ValueError("attempts must be >= 1")
        self._rng = np.random.default_rng(self.seed)
        self.slept: list[float] = []

    def delay(self, attempt: int) -> float:
        raw = self.base * self.mult ** attempt
        raw *= 1.0 + self.jitter * float(self._rng.random())
        return min(raw, self.max_delay)

    def backoff(self, attempt: int) -> None:
        d = self.delay(attempt)
        self.slept.append(d)
        telemetry.REGISTRY.counter("transport.retries").inc()
        telemetry.REGISTRY.histogram("transport.backoff_s").observe(d)
        with tracing.TRACER.span("retry.backoff", category="host",
                                 attempt=attempt, delay_s=d):
            self.sleeper(d)


class CircuitBreaker:
    """Per-party consecutive-failure breaker with half-open probes.

    ``record_failure`` K times in a row opens party i's circuit; ``allow``
    then raises :class:`CircuitOpenError` so callers fail fast instead of
    burning a timeout budget per request on a party that is plainly down.
    A recorded success closes the circuit again (the coordinator records one
    after every completed round-trip).

    With ``cooldown_s=None`` (the default) an open circuit stays open until
    a success or ``reset``.  With a cooldown, ``allow`` transitions
    open→half_open once ``cooldown_s`` has elapsed on the (injectable)
    ``clock`` and lets the probe through; the probe's success closes the
    circuit, its failure re-opens it immediately.

    Observer seam: every state flip calls ``on_transition(party, old,
    new)``, increments ``transport.breaker.<new>`` in the telemetry
    registry, records an instant trace span, and is appended to the
    bounded ``transitions`` log.
    """

    _MAX_LOG = 256

    def __init__(self, threshold: int = 3, *,
                 cooldown_s: float | None = None,
                 clock: Callable[[], float] = time.monotonic,
                 on_transition: Callable[[int, str, str], None] | None = None):
        if threshold < 1:
            raise ValueError("breaker threshold must be >= 1")
        if cooldown_s is not None and cooldown_s < 0:
            raise ValueError("breaker cooldown_s must be >= 0")
        self.threshold = int(threshold)
        self.cooldown_s = cooldown_s
        self.clock = clock
        self.on_transition = on_transition
        self._fails: dict[int, int] = {}
        self._state: dict[int, str] = {}
        self._opened_at: dict[int, float] = {}
        self.transitions: list[tuple[int, str, str]] = []

    def state(self, party: int) -> str:
        return self._state.get(party, "closed")

    def _transition(self, party: int, new: str) -> None:
        old = self.state(party)
        if old == new:
            return
        if new == "closed":
            self._state.pop(party, None)
        else:
            self._state[party] = new
        if new == "open":
            self._opened_at[party] = self.clock()
        else:
            self._opened_at.pop(party, None)
        if len(self.transitions) < self._MAX_LOG:
            self.transitions.append((party, old, new))
        telemetry.REGISTRY.counter(f"transport.breaker.{new}").inc()
        tracing.TRACER.event("breaker", category="host", party=party,
                             from_state=old, to_state=new)
        if self.on_transition is not None:
            self.on_transition(party, old, new)

    def record_failure(self, party: int) -> None:
        self._fails[party] = self._fails.get(party, 0) + 1
        if self.state(party) == "half_open":
            # a failed probe re-opens immediately, whatever the count
            self._transition(party, "open")
        elif self._fails[party] >= self.threshold:
            self._transition(party, "open")

    def record_success(self, party: int) -> None:
        self._fails.pop(party, None)
        self._transition(party, "closed")

    def is_open(self, party: int) -> bool:
        return self.state(party) == "open"

    def open_parties(self) -> tuple[int, ...]:
        return tuple(sorted(p for p in self._state
                            if self._state[p] == "open"))

    def allow(self, party: int) -> None:
        if not self.is_open(party):
            return
        if self.cooldown_s is not None:
            opened = self._opened_at.get(party)
            if opened is not None and \
                    self.clock() - opened >= self.cooldown_s:
                self._transition(party, "half_open")
                return  # probe allowed
        raise CircuitOpenError(
            f"party {party}: circuit open after "
            f"{self._fails.get(party, self.threshold)} consecutive failures",
            parties=(party,))

    def reset(self, party: int | None = None) -> None:
        parties = tuple(self._state) if party is None else (party,)
        if party is None:
            self._fails.clear()
        else:
            self._fails.pop(party, None)
        for p in parties:
            self._transition(p, "closed")
