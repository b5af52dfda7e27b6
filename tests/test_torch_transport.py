"""The port's wire transport, held against the JAX package's.

Frames: ``pack`` of the same message is the same bytes in both packages —
NumPy arrays of every dtype the protocol ships (tensors through
``.cpu().numpy()``), nested maps and lists, and a PartyTree — and
``unpack`` gives the same values back.  Fault tolerance: ``RetryPolicy``
draws the same backoff schedule for a seed, and ``CircuitBreaker`` walks
the same transitions.  ``surviving_trees`` picks the same trees of one
forest.  The ``Channel`` frames over a real loopback socket, with its
timeout and closed-peer errors, trace-context stamping and counters."""
import socket

import numpy as np
import pytest
import torch

from repro.core import ForestParams as JParams
from repro.data import make_classification as j_make_classification
from repro.federation import Federation as JFederation
from repro.federation import distributed as jdist
from repro.federation import transport as jt
from repro_torch import convert
from repro_torch.core.tree import PartyTree
from repro_torch.federation import distributed
from repro_torch.federation import transport as tt
from repro_torch.observability import registry as telemetry
from repro_torch.observability import trace as tracing

# one array per dtype the protocol ships: bins, node slots and gids, counts,
# gains and stats, boundaries, masks and flags, hashed IDs, raw IDs
_DTYPES = (np.uint8, np.int32, np.int64, np.float32, np.float64, np.bool_)


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    out = {np.dtype(d).name: (rng.integers(0, 200, size=(3, 5)).astype(d)
                              if d is not np.bool_
                              else rng.integers(0, 2, size=(3, 5)) > 0)
           for d in _DTYPES}
    out["gain"] = np.array([-np.inf, 0.5, np.nan], np.float32)
    out["hashes"] = np.asarray(["a3f0", "09bc", "ffff"])
    out["empty"] = np.zeros((0, 4), np.float32)
    out["scalar"] = np.asarray(7, np.int32)
    return out


def _message(arrays):
    return {"op": "coll", "run": 3, "seq": 0, "kind": "gather",
            "data": [arrays[k] for k in sorted(arrays)],
            "payload": {"nested": {"x": arrays["float32"], "n": None,
                                   "flag": True, "name": "party0"},
                        "ints": [1, -2, 2**40], "f": 0.25}}


@pytest.mark.parametrize("seed", [0, 1])
def test_frames_byte_identical_to_jax(seed):
    msg = _message(_arrays(seed))
    frame = tt.pack(msg)
    assert frame == jt.pack(msg)
    got = tt.unpack(frame[4:])
    want = jt.unpack(frame[4:])
    for a, b in zip(got["data"], want["data"]):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got["payload"]["nested"]["x"],
                                  msg["payload"]["nested"]["x"])
    assert got["payload"]["ints"] == [1, -2, 2**40]


def test_tensors_frame_as_their_numpy():
    arrays = _arrays(2)
    tensors = {k: torch.as_tensor(v) for k, v in arrays.items()
               if k != "hashes"}
    numpy = {k: arrays[k] for k in tensors}
    assert tt.pack(_message(tensors)) == jt.pack(_message(numpy))
    assert tt.pack({"x": np.int32(5)}) == jt.pack({"x": np.int32(5)})


def _forest():
    x, y = j_make_classification(160, 9, 2, seed=0)
    jfed = JFederation(parties=3, n_bins=8)
    jfed.ingest(x, y)
    return jfed.fit(JParams(n_estimators=6, max_depth=3, n_bins=8,
                            max_features=0.34, seed=0))


@pytest.fixture(scope="module")
def jax_forest():
    return _forest()


def test_party_tree_frames_byte_identical(jax_forest):
    jtrees = jdist.PartyTree(*(np.asarray(a) for a in jax_forest.trees_))
    ttrees = convert.party_trees_from_numpy(jtrees, "cpu")
    msg = {"op": "result", "run": 1, "data": ttrees}
    frame = tt.pack(msg)
    assert frame == jt.pack({"op": "result", "run": 1, "data": jtrees})
    back = tt.unpack(frame[4:])["data"]
    assert isinstance(back, PartyTree)
    for f in PartyTree._fields:
        np.testing.assert_array_equal(getattr(back, f), getattr(jtrees, f))


def test_unregistered_namedtuple_refused():
    from typing import NamedTuple

    class Stray(NamedTuple):
        a: int

    with pytest.raises(TypeError, match="wire-registered"):
        tt.pack({"x": Stray(1)})
    with pytest.raises(TypeError, match="cannot encode"):
        tt.pack({"x": np.array([object()])})


@pytest.mark.parametrize("seed", [0, 7])
def test_retry_schedule_equal_to_jax(seed):
    a = tt.RetryPolicy(attempts=5, base=0.01, seed=seed,
                       sleeper=lambda d: None)
    b = jt.RetryPolicy(attempts=5, base=0.01, seed=seed,
                       sleeper=lambda d: None)
    before = telemetry.REGISTRY.counter("transport.retries").value
    for k in range(4):
        a.backoff(k)
        b.backoff(k)
    assert a.slept == b.slept and len(a.slept) == 4
    assert telemetry.REGISTRY.counter("transport.retries").value == before + 4
    with pytest.raises(ValueError):
        tt.RetryPolicy(attempts=0)


def _drive_breaker(mod):
    """The same call sequence on either package's breaker: opens after 2
    failures, fails fast, half-opens after the cooldown, a failed probe
    re-opens, a successful one closes."""
    now = [0.0]
    seen = []
    br = mod.CircuitBreaker(2, cooldown_s=5.0, clock=lambda: now[0],
                            on_transition=lambda *t: seen.append(t))
    log = []
    for step in ("f0", "f0", "a0", "t6", "a0", "f0", "a0", "t12", "a0",
                 "s0", "a0", "f1", "r", "a1"):
        kind, arg = step[0], step[1:]
        try:
            if kind == "f":
                br.record_failure(int(arg))
            elif kind == "s":
                br.record_success(int(arg))
            elif kind == "a":
                br.allow(int(arg))
            elif kind == "t":
                now[0] = float(arg)
            elif kind == "r":
                br.reset()
            log.append((step, "ok", br.state(0), br.state(1)))
        except mod.CircuitOpenError as e:
            log.append((step, "open", e.parties))
    return log, list(br.transitions), seen, br.open_parties()


def test_breaker_transitions_equal_to_jax():
    before = telemetry.REGISTRY.counter("transport.breaker.open").value
    got = _drive_breaker(tt)
    want = _drive_breaker(jt)
    assert got == want
    assert ("a0", "open", (0,)) in got[0]
    assert [t[2] for t in got[1]] == ["open", "half_open", "open",
                                      "half_open", "closed"]
    assert telemetry.REGISTRY.counter("transport.breaker.open").value \
        == before + 2


def test_surviving_trees_equal_to_jax(jax_forest):
    ttrees = convert.party_trees_from_numpy(jax_forest.trees_, "cpu")
    for dead in ([], [0], [1], [2], [0, 2], [0, 1, 2]):
        want = jdist.surviving_trees(jax_forest.trees_, dead)
        got = distributed.surviving_trees(ttrees, dead)
        np.testing.assert_array_equal(got, want)
    assert distributed.surviving_trees(ttrees, [0]).size > 0


def _channel_pair():
    lst = socket.socket()
    lst.bind(("127.0.0.1", 0))
    lst.listen(1)
    a = socket.create_connection(lst.getsockname(), timeout=5)
    b, _ = lst.accept()
    lst.close()
    return tt.Channel(a, party=0), tt.Channel(b, party=1)


def test_channel_roundtrip_timeout_and_close():
    tx, rx = _channel_pair()
    try:
        msg = _message(_arrays(3))
        tx.send(msg)
        got = rx.recv(timeout=5)
        assert "_trace" not in got                  # tracing is off
        for a, b in zip(got["data"], msg["data"]):
            np.testing.assert_array_equal(a, b)
        with pytest.raises(tt.PartyTimeout) as err:
            rx.recv(timeout=0.05)
        assert err.value.parties == (1,)
        tx.close()
        with pytest.raises(tt.PartyDead):
            rx.recv(timeout=5)
    finally:
        tx.close()
        rx.close()


def test_channel_stamps_trace_context():
    tx, rx = _channel_pair()
    tracer = tracing.TRACER
    was = tracer.enabled
    try:
        tracer.enable()
        with tracer.span("coordinator.round") as span:
            tx.send({"op": "ping"})
            got = rx.recv(timeout=5)
        assert got["_trace"] == {"tid": span.tid, "sid": span.sid}
    finally:
        if not was:
            tracer.disable()
        tx.close()
        rx.close()


def test_connect_gives_up_after_the_policy():
    lst = socket.socket()
    lst.bind(("127.0.0.1", 0))
    port = lst.getsockname()[1]
    lst.close()                                      # nobody listens
    policy = tt.RetryPolicy(attempts=2, base=0.0, seed=0,
                            sleeper=lambda d: None)
    with pytest.raises(tt.PartyDead, match="2 attempts"):
        tt.connect("127.0.0.1", port, timeout=1.0, retry=policy)
    assert len(policy.slept) == 1
