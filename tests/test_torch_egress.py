"""The port's runtime egress guard against the JAX package's.

The suite runs armed (``REPRO_EGRESS_GUARD=1``, tests/conftest.py).  The
same message pytrees through both packages' ``check_egress`` raise with
equal key paths and labels; ``PartyBlock`` and ``SourceScan`` tag their
raw fields with the JAX package's labels; a tensor over a raw buffer is
refused (``torch.from_numpy``, a tensor slice, a column view, the
``.numpy()`` of such a tensor) while a ``.clone()`` is clean, and a dead
buffer's address range matches nothing.  Through a real TCP ``Channel``
(tests/test_distributed.py's wire test, tensors added) raw payloads are
refused with their key path and hashed IDs round-trip; the same tensor
payload that the JAX package's codec frames unseen is refused by the
port's.  Streaming one source counts the same increments in both
packages.
"""
import gc
import socket
from collections import namedtuple

import numpy as np
import pytest
import torch

from repro.analysis import runtime as j_rt
from repro.core.partyblock import PartyBlock as JBlock
from repro.federation.transport import Channel as JChannel
from repro.observability import registry as j_telemetry
from repro.observability import trace as j_tracing
from repro.streaming import ArraySource as JArraySource
from repro.streaming import scan_source as j_scan_source
from repro.streaming import streaming_ingest as j_streaming_ingest
from repro_torch.analysis import runtime as rt
from repro_torch.core.partyblock import PartyBlock
from repro_torch.data import make_classification, make_party_views
from repro_torch.federation.transport import Channel
from repro_torch.observability import registry as telemetry
from repro_torch.observability import trace as tracing
from repro_torch.streaming import ArraySource, scan_source, streaming_ingest

Wrapped = namedtuple("Wrapped", "meta blob")


def _pair(cls):
    lst = socket.socket()
    lst.bind(("127.0.0.1", 0))
    lst.listen(1)
    a = socket.create_connection(lst.getsockname(), timeout=5)
    b, _ = lst.accept()
    lst.close()
    return cls(a, party=0), cls(b, party=0)


def _close(*chs):
    for ch in chs:
        ch.sock.close()


def _blocks(name="acme"):
    x = np.arange(24.0).reshape(6, 4)
    ids, y = np.arange(6), np.zeros(6, np.int64)
    return (PartyBlock(name=name, x=x, ids=ids, y=y),
            JBlock(name=name, x=x, ids=ids, y=y))


def test_both_guards_are_armed():
    assert rt.enabled() and j_rt.enabled(), \
        "tests/conftest.py must set REPRO_EGRESS_GUARD=1"


# ------------------------------------------------------------ runtime parity
_MESSAGES = {
    "nested dict": lambda a: {"op": "x", "payload": {"ids": a}},
    "namedtuple field": lambda a: {"w": Wrapped(meta=1, blob=a)},
    "list index": lambda a: {"parts": [np.ones(2), a]},
    "tuple in list": lambda a: [("meta", {"k": a})],
    "column view": lambda a: {"col": a.reshape(3, 4)[:, 1]},
}


@pytest.mark.parametrize("case", sorted(_MESSAGES))
def test_check_egress_path_and_label_equal_jax(case):
    arr = np.arange(12.0)
    label = f"raw array for the {case} case"
    rt.taint(arr, label)
    j_rt.taint(arr, label)
    msg = _MESSAGES[case](arr)
    with pytest.raises(rt.PrivacyViolationError) as port:
        rt.check_egress(msg, context="unit")
    with pytest.raises(j_rt.PrivacyViolationError) as ref:
        j_rt.check_egress(msg, context="unit")
    assert (port.value.path, port.value.label) \
        == (ref.value.path, ref.value.label)
    assert port.value.label == label and str(port.value) == str(ref.value)
    # and both pass the same message with the raw buffer copied
    clean = _MESSAGES[case](arr.copy())
    rt.check_egress(clean)
    j_rt.check_egress(clean)


def test_allow_egress_scopes_the_allowance():
    arr = rt.taint(np.ones(3), "raw for allowance test")
    with rt.allow_egress("unit test provisioning"):
        rt.check_egress({"x": arr})
        rt.check_egress({"x": torch.from_numpy(arr)})
    with pytest.raises(rt.PrivacyViolationError):
        rt.check_egress({"x": arr})
    with pytest.raises(ValueError):
        rt.allow_egress(" ")


# ---------------------------------------------------------------------- tags
def test_partyblock_labels_equal_jax():
    block, jblock = _blocks("credit")
    for field in ("x", "ids", "y"):
        label = rt.lookup(getattr(block, field))
        assert label is not None and label == j_rt.lookup(
            getattr(jblock, field)), field
    assert "raw features" in rt.lookup(block.x)
    assert rt.lookup(block.hashed_ids("salt")) is None
    assert rt.lookup(PartyBlock(name="n", x=np.ones((2, 1)),
                                ids=np.arange(2)).y) is None


def test_sourcescan_labels_equal_jax():
    x, y = make_classification(40, 4, 2, seed=3)
    ids = np.arange(100, 140)
    scan = scan_source(ArraySource(PartyBlock(name="s", x=x, ids=ids, y=y)),
                       chunk_rows=7)
    jscan = j_scan_source(JArraySource(JBlock(name="s", x=x, ids=ids, y=y)),
                          chunk_rows=7)
    assert rt.lookup(scan.ids) == j_rt.lookup(jscan.ids) \
        == "SourceScan['s'].ids (raw sample IDs)"
    assert rt.lookup(scan.y) == j_rt.lookup(jscan.y) \
        == "SourceScan['s'].y (raw labels)"
    assert rt.lookup(scan.hashes) is None


# ------------------------------------------------------------------- tensors
_TENSOR_VIEWS = {
    "from_numpy": lambda b: torch.from_numpy(b.x),
    "tensor slice": lambda b: torch.from_numpy(b.x)[2:4],
    "column view": lambda b: torch.from_numpy(b.x[:, 1]),
    "tensor column": lambda b: torch.from_numpy(b.x)[:, 3],
    "numpy of a tensor": lambda b: torch.from_numpy(b.x)[1:].numpy(),
    "ids tensor": lambda b: torch.from_numpy(b.ids),
}


@pytest.mark.parametrize("case", sorted(_TENSOR_VIEWS))
def test_tensor_over_a_raw_buffer_is_caught(case):
    block, _ = _blocks()
    obj = _TENSOR_VIEWS[case](block)
    field = "ids" if case.startswith("ids") else "x"
    assert rt.lookup(obj) == rt.lookup(getattr(block, field))
    with pytest.raises(rt.PrivacyViolationError) as ei:
        rt.check_egress({"payload": [obj]})
    assert ei.value.path == "msg['payload'][0]"


def test_tensor_copies_are_clean():
    block, _ = _blocks()
    t = torch.from_numpy(block.x)
    for copy in (t.clone(), t[[0, 2]], t + 0, torch.tensor(block.x),
                 torch.from_numpy(block.x.copy())):
        assert rt.lookup(copy) is None
        rt.check_egress({"x": copy})


def test_a_dead_buffer_matches_nothing():
    """The range match holds only while the tagged array lives: memory
    that outlives it (here a bytearray) is no longer raw data."""
    buf = bytearray(64)
    arr = rt.taint(np.frombuffer(buf, dtype=np.float64), "short-lived raw")
    t = torch.frombuffer(buf, dtype=torch.float64)
    assert rt.lookup(t) == "short-lived raw"
    del arr
    gc.collect()
    assert rt.lookup(t) is None
    rt.check_egress({"x": t})


# ---------------------------------------------------------------------- wire
def test_egress_guard_blocks_raw_send_and_names_the_key():
    """tests/test_distributed.py's wire test through the port's Channel,
    with tensor payloads added: the wire refuses, the error names the
    payload key path and the label; sanitized traffic flows untouched."""
    tx, rx = _pair(Channel)
    try:
        block = PartyBlock(name="leaky", x=np.arange(10.0).reshape(5, 2),
                           ids=np.arange(5), y=np.zeros(5, np.int64))
        with pytest.raises(rt.PrivacyViolationError) as ei:
            tx.send({"op": "leak", "payload": {"x": block.x}})
        assert ei.value.path == "msg['payload']['x']"
        assert "raw features" in str(ei.value)
        assert "'leaky'" in str(ei.value)
        assert "Channel.send(party=0)" in str(ei.value)
        with pytest.raises(rt.PrivacyViolationError) as ei:
            tx.send({"op": "leak", "ids": block.ids})
        assert ei.value.path == "msg['ids']"
        assert "raw sample IDs" in str(ei.value)
        for key, payload in (("col", block.x[:, 0]),
                             ("t", torch.from_numpy(block.x)),
                             ("t_slice", torch.from_numpy(block.x)[1:3]),
                             ("y", torch.from_numpy(block.y))):
            with pytest.raises(rt.PrivacyViolationError) as ei:
                tx.send({"op": "leak", key: payload})
            assert ei.value.path == f"msg[{key!r}]"
        # the sanctioned protocol messages are untouched and round-trip
        hashes = block.hashed_ids("salt0")
        clone = torch.from_numpy(block.x).clone()
        tx.send({"op": "hashes", "hashes": hashes, "clone": clone})
        got = rx.recv(timeout=10)
        np.testing.assert_array_equal(np.asarray(got["hashes"]), hashes)
        np.testing.assert_array_equal(got["clone"], block.x)
    finally:
        _close(tx, rx)


def test_same_payload_through_both_channels():
    """Both wires refuse the raw ndarray with the same path and label.  A
    CPU tensor over it is framed unseen by the JAX package's codec (its
    ``.base`` walk cannot see through a tensor), and refused by the
    port's."""
    block, jblock = _blocks("both")
    tx, rx = _pair(Channel)
    jtx, jrx = _pair(JChannel)
    try:
        msg = {"op": "leak", "payload": {"x": block.x}}
        with pytest.raises(rt.PrivacyViolationError) as port:
            tx.send(msg)
        with pytest.raises(j_rt.PrivacyViolationError) as ref:
            jtx.send(msg)
        assert (port.value.path, port.value.label) \
            == (ref.value.path, ref.value.label)
        tensor_msg = {"op": "leak", "payload": {"x": torch.from_numpy(
            jblock.x)}}
        jtx.send(tensor_msg)
        np.testing.assert_array_equal(jrx.recv(timeout=10)["payload"]["x"],
                                      block.x)
        with pytest.raises(rt.PrivacyViolationError) as port:
            tx.send(tensor_msg)
        assert port.value.path == "msg['payload']['x']"
        assert port.value.label == ref.value.label
    finally:
        _close(tx, rx, jtx, jrx)


# ---------------------------------------------------------------- streaming
_STREAM_COUNTERS = ("streaming.chunks_scanned", "streaming.rows_scanned",
                    "streaming.rows_binned", "streaming.sketch_compactions")


def _counts(registry):
    return [0 if registry.get(n) is None else registry.get(n).value
            for n in _STREAM_COUNTERS]


def test_streaming_counters_and_events_equal_jax():
    """One streamed ingest (a capacity small enough to compact) counts the
    same increments, and traces the same ``stream.scan`` / ``stream.bin``
    events, in both packages."""
    x, y = make_classification(300, 6, 2, seed=11)
    blocks, _, _ = make_party_views(x, y, 2, overlap=0.8, seed=11)
    jblocks = [JBlock(name=b.name, x=b.x, ids=b.ids, y=b.y,
                      feature_ids=b.feature_ids) for b in blocks]
    before = (_counts(telemetry.REGISTRY), _counts(j_telemetry.REGISTRY))
    events = []
    for tracer, run in (
            (tracing.TRACER, lambda: streaming_ingest(
                [ArraySource(b) for b in blocks], 8, chunk_rows=37,
                capacity=16)),
            (j_tracing.TRACER, lambda: j_streaming_ingest(
                [JArraySource(b) for b in jblocks], 8, chunk_rows=37,
                capacity=16))):
        tracer.reset()
        tracer.enable()
        try:
            run()
            events.append([(s["name"], s["attrs"]) for s in tracer.drain()
                           if s["name"].startswith("stream.")])
        finally:
            tracer.disable()
    port = np.subtract(_counts(telemetry.REGISTRY), before[0])
    ref = np.subtract(_counts(j_telemetry.REGISTRY), before[1])
    np.testing.assert_array_equal(port, ref)
    assert port[0] > 0 and port[3] > 0
    assert port[1] == sum(b.n_samples for b in blocks)
    assert events[0] == events[1]
    assert {name for name, _ in events[0]} == {"stream.scan", "stream.bin"}
