"""Fault injection on the port's party-per-process substrate: the five
chaos, degraded and refusal cases of tests/test_distributed.py, on CPU
workers.

Every failure mode the coordinator claims to handle is shown
deterministically through the workers' one-shot chaos hook:

  * ``drop_run``  — the round times out, the jittered-backoff retry
    recovers it exactly (and the injectable sleeper records the schedule);
  * ``delay_run`` — a PartyTimeout surfaces when the retry budget is 1,
    and the aborted worker rejoins the next round;
  * ``die``       — the dead party is detected, retries fast-fail, the
    circuit breaker opens, health() reports the party down;
  * degraded serving — after a kill, ForestServer answers from the trees
    whose split paths avoid the dead party's features, exactly; without
    ``allow_degraded`` a dead party is a hard serving error.
"""
import time

import numpy as np
import pytest

from repro_torch.core import ForestParams
from repro_torch.core.tree import PartyTree
from repro_torch.data import make_classification
from repro_torch.federation import Federation, distributed
from repro_torch.federation.distributed import (DistributedSubstrate,
                                                surviving_trees)
from repro_torch.federation.transport import (CircuitOpenError, PartyDead,
                                              PartyTimeout,
                                              PartyUnavailableError,
                                              RetryPolicy)
from repro_torch.serving import ServeConfig

M = 3


def _toy(sub):
    """The cheap two-collective conformance protocol — runs in NumPy at the
    workers."""
    prog = sub.program(None, 1, 1,
                       distributed=distributed.toy_affine_spec())
    x = np.arange(sub.n_parties * 4, dtype=np.int32).reshape(
        sub.n_parties, 4)
    return prog, x, np.int32(3)


def test_retry_recovers_dropped_round():
    """A swallowed run message times out; the retry replays the round
    bit-identically, sleeping the deterministic jittered-backoff schedule."""
    policy = RetryPolicy(attempts=3, base=0.01, seed=7,
                         sleeper=lambda d: None)
    sub = DistributedSubstrate(2, device="cpu", round_timeout=2.0,
                               retry=policy)
    try:
        prog, x, s = _toy(sub)
        want = np.asarray(prog(x, s))           # healthy round first
        sub.chaos(0, "drop_run")
        got = np.asarray(prog(x, s))
        np.testing.assert_array_equal(got, want)
        assert len(policy.slept) == 1           # one timeout, one backoff
        twin = RetryPolicy(attempts=3, base=0.01, seed=7)
        assert policy.slept[0] == twin.delay(0)  # schedule is reproducible
    finally:
        sub.shutdown()


def test_round_timeout_surfaces_then_worker_rejoins():
    """With a retry budget of 1, a delayed party surfaces PartyTimeout
    attributed to it; the abort unblocks the worker, which serves the next
    round normally."""
    sub = DistributedSubstrate(2, device="cpu", round_timeout=1.0,
                               retry=RetryPolicy(attempts=1))
    try:
        prog, x, s = _toy(sub)
        want = np.asarray(prog(x, s))
        sub.chaos(1, "delay_run", seconds=2.0)
        with pytest.raises(PartyTimeout) as err:
            prog(x, s)
        assert err.value.parties == (1,)
        time.sleep(2.0)                  # let the worker wake + drain abort
        np.testing.assert_array_equal(np.asarray(prog(x, s)), want)
    finally:
        sub.shutdown()


def test_killed_party_opens_circuit_breaker():
    """A hard process death fails the round on every retry, opens the
    party's circuit (later calls fail fast, no timeout burned), and shows
    up in health() and unavailable_parties()."""
    policy = RetryPolicy(attempts=3, base=0.01, seed=0,
                         sleeper=lambda d: None)
    sub = DistributedSubstrate(2, device="cpu", round_timeout=10.0,
                               retry=policy, breaker_threshold=3)
    try:
        prog, x, s = _toy(sub)
        prog(x, s)                              # healthy round first
        sub.chaos(1, "die")
        with pytest.raises(PartyDead):
            prog(x, s)                          # all 3 attempts fail
        assert len(policy.slept) == 2           # backoff between attempts
        assert 1 in sub.unavailable_parties()
        with pytest.raises(CircuitOpenError):
            prog(x, s)                          # breaker: fail fast
        h = sub.health(timeout=2.0)
        assert h[1] is None and h[0] is not None
    finally:
        sub.shutdown()


def test_degraded_serving_after_kill_is_exact():
    """Kill a party mid-traffic: with allow_degraded the server answers
    from the trees whose split paths avoid the dead party's features —
    bit-identical to a forest holding only those trees (their masks never
    consult the dead party, so the leaf intersection is unchanged)."""
    p = ForestParams(n_estimators=10, max_depth=3, n_bins=8,
                     max_features=0.34, seed=0)
    x, y = make_classification(160, 9, 2, seed=0)
    sim = Federation(parties=M, n_bins=8, device="cpu")
    sim.ingest(x, y)
    ref = sim.fit(p)
    fed = Federation(parties=M, substrate="distributed", n_bins=8,
                     device="cpu",
                     retry=RetryPolicy(attempts=2, base=0.01, seed=0,
                                       sleeper=lambda d: None))
    try:
        fed.ingest(x, y)
        model = fed.fit(p)
        server = fed.serve(model, ServeConfig(buckets=(32,),
                                              allow_degraded=True))
        xt = x[:30]
        want = sim.predict(ref, xt)
        np.testing.assert_array_equal(server.serve(xt), want)
        assert not server.wave_stats[-1].get("degraded")

        # kill the party the most trees' split paths avoid
        survivors = {pi: surviving_trees(model.trees_, [pi]).size
                     for pi in range(M)}
        victim = max(survivors, key=survivors.get)
        assert survivors[victim] > 0, "fixture forest has no avoider trees"
        fed.substrate.chaos(victim, "die")
        got = server.serve(xt)
        stats = server.wave_stats[-1]
        assert stats.get("degraded")
        assert victim in stats["dead_parties"]
        assert stats["n_trees"] == survivors[victim]
        assert victim in fed.substrate.unavailable_parties()

        sel = surviving_trees(ref.trees_, [victim])
        deg = type(ref)(p, device="cpu")
        deg.trees_ = PartyTree(*(a[:, sel] for a in ref.trees_))
        deg.partition_ = ref.partition_
        deg._decode = ref._decode
        np.testing.assert_array_equal(got, deg.predict(xt))
        # the next wave reuses the degraded program (no new bind)
        np.testing.assert_array_equal(server.serve(xt[:7]), got[:7])
        assert len(server._degraded) == 1
    finally:
        fed.close()


def test_degraded_serving_refused_without_optin():
    """Without allow_degraded a dead party is a hard serving error — no
    silently approximate answers."""
    p = ForestParams(n_estimators=2, max_depth=3, n_bins=8, seed=0)
    x, y = make_classification(80, 6, 2, seed=1)
    fed = Federation(parties=M, substrate="distributed", n_bins=8,
                     device="cpu",
                     retry=RetryPolicy(attempts=2, base=0.01, seed=0,
                                       sleeper=lambda d: None))
    try:
        fed.ingest(x, y)
        model = fed.fit(p)
        server = fed.serve(model, ServeConfig(buckets=(32,)))
        server.serve(x[:10])
        fed.substrate.chaos(0, "die")
        with pytest.raises(PartyUnavailableError):
            server.serve(x[:10])
    finally:
        fed.close()
