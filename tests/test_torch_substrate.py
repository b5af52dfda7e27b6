"""Substrate conformance in the port: every registered substrate, one
contract — the cases of tests/test_substrate_conformance.py for the
simulated, the sharded (two gloo ranks on the CPU) and the
party-per-process substrates.

Parameterized over the ``SUBSTRATES`` registry, so a newly registered
substrate is pulled into the suite (and fails loudly until this file's
fixture knows how to build it).  The contract:

  * the toy two-collective protocol (``toy_affine``: gather + sum + the
    party index) is bit-identical to the simulated substrate at the same
    party count — and to the JAX package's simulated toy;
  * the lifecycle seams behave: ``compile`` returns an executable with
    unchanged semantics, ``context`` is re-enterable, ``exchange`` is the
    transport seam (None in process, a real round trip distributed),
    ``shutdown`` is idempotent;
  * ``resolve_substrate`` validates party counts and rejects unknown names
    with the registry listing;
  * ``register_substrate`` round-trips a new factory through resolution.
"""
import numpy as np
import pytest

from repro.federation import distributed as jdist
from repro.federation.substrate import SimulatedSubstrate as JSimulated
from repro_torch.federation import distributed
from repro_torch.federation.substrate import (SUBSTRATES, SimulatedSubstrate,
                                              register_substrate,
                                              resolve_substrate)
from repro_torch.launch.mesh import make_host_mesh

# party count each substrate runs the toy collective at
PARTY_COUNTS = {"simulated": 3, "sharded": 2, "distributed": 2}


@pytest.fixture(scope="module")
def pool():
    subs = {
        "simulated": resolve_substrate("simulated"),
        "distributed": resolve_substrate(
            "distributed", parties=PARTY_COUNTS["distributed"],
            device="cpu"),
        "sharded": resolve_substrate(
            "sharded", mesh=make_host_mesh(PARTY_COUNTS["sharded"]),
            parties=PARTY_COUNTS["sharded"], device="cpu"),
    }
    missing = set(SUBSTRATES) - set(subs)
    assert not missing, (
        f"substrates {sorted(missing)} are registered but the conformance "
        f"fixture does not build them — add them to this suite")
    yield subs
    subs["distributed"].shutdown()
    subs["sharded"].shutdown()


def _toy(sub, m: int) -> np.ndarray:
    x = np.arange(m * 4, dtype=np.int32).reshape(m, 4)
    prog = sub.program(distributed.toy_affine_fn, 1, 1,
                       distributed=distributed.toy_affine_spec())
    with sub.context():
        out = sub.compile(prog)(x, np.int32(3))
    return np.asarray(out)


def test_registry_is_fully_covered():
    assert set(PARTY_COUNTS) == set(SUBSTRATES)


@pytest.mark.parametrize("name", sorted(PARTY_COUNTS))
def test_toy_collective_bit_identity(pool, name):
    """Both collectives + the party index, bit-identical to the simulation
    at the same party count, on every registered substrate."""
    m = PARTY_COUNTS[name]
    got = _toy(pool[name], m)
    want = _toy(SimulatedSubstrate(), m)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("m", [1, 2, 3])
def test_toy_collective_equals_jax(m):
    """The port's in-process twin of the toy protocol equals the JAX
    package's simulated one."""
    x = np.arange(m * 4, dtype=np.int32).reshape(m, 4)
    sub = JSimulated()
    want = np.asarray(sub.compile(sub.program(jdist.toy_affine_fn, 1, 1))(
        x, np.int32(3)))
    np.testing.assert_array_equal(_toy(SimulatedSubstrate(), m), want)


@pytest.mark.parametrize("name", sorted(PARTY_COUNTS))
def test_jit_matches_compile(pool, name):
    """``jit`` (program + compile in one step) agrees with the two-step
    path — on the distributed substrate both are the protocol itself."""
    sub, m = pool[name], PARTY_COUNTS[name]
    x = np.arange(m * 4, dtype=np.int32).reshape(m, 4)
    run = sub.jit(distributed.toy_affine_fn, 1, 1,
                  distributed=distributed.toy_affine_spec())
    with sub.context():
        np.testing.assert_array_equal(np.asarray(run(x, np.int32(3))),
                                      _toy(sub, m))


@pytest.mark.parametrize("name", sorted(PARTY_COUNTS))
def test_context_is_reenterable(pool, name):
    for _ in range(2):
        with pool[name].context():
            pass


@pytest.mark.parametrize("name", sorted(PARTY_COUNTS))
def test_exchange_seam(pool, name):
    """In process there is no transport: exchange is None.  The distributed
    and sharded substrates answer a real ping round trip, to one party (a
    rank) or to all."""
    r = pool[name].exchange("ping", party=0)
    if name in ("distributed", "sharded"):
        assert r["op"] == "pong" and r["party"] == 0
        every = pool[name].exchange("ping")
        assert sorted(every) == [0, 1]
    else:
        assert r is None


def test_shutdown_idempotent(pool):
    pool["simulated"].shutdown()
    pool["simulated"].shutdown()     # in process: nothing to tear down, twice
    cold = distributed.DistributedSubstrate(2, device="cpu")
    cold.shutdown()                  # never started: no workers to reap
    cold.shutdown()
    assert cold.unavailable_parties() == ()


def test_resolve_validates_party_count(pool):
    with pytest.raises(ValueError, match="executes"):
        resolve_substrate(pool["distributed"], parties=5)
    assert resolve_substrate(pool["distributed"], parties=2) \
        is pool["distributed"]
    # the simulation runs any party count: no n_parties to contradict
    assert resolve_substrate(pool["simulated"], parties=7) is pool["simulated"]
    with pytest.raises(ValueError, match="party count"):
        resolve_substrate("distributed", device="cpu")
    with pytest.raises(TypeError, match="no options"):
        resolve_substrate("simulated", round_timeout=1.0)


def test_resolve_unknown_name_lists_registry():
    with pytest.raises(ValueError, match="registered"):
        resolve_substrate("carrier-pigeon")
    with pytest.raises(ValueError, match="registered"):
        resolve_substrate(42)


def test_register_substrate_roundtrip():
    """A decorated factory resolves by name and receives the factory
    options; unregistering restores the registry."""
    calls = {}

    @register_substrate("test-echo")
    def _make(parties=None, **opts):
        calls.update(opts, parties=parties)
        return SimulatedSubstrate()

    try:
        sub = resolve_substrate("test-echo", parties=4, flavor="x")
        assert isinstance(sub, SimulatedSubstrate)
        assert calls == {"parties": 4, "flavor": "x"}
    finally:
        del SUBSTRATES["test-echo"]
    with pytest.raises(ValueError, match="registered"):
        resolve_substrate("test-echo")


def test_programs_without_a_protocol_body_refused(pool):
    """Only forest fit/predict, F-LR predict and the toy protocol run
    party-per-process; anything else raises, as in the JAX package."""
    with pytest.raises(NotImplementedError, match="no distributed"):
        pool["distributed"].program(lambda x: x, 1, 0)
