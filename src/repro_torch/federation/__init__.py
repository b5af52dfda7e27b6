"""Federation session API — one entry point for the federated lifecycle.

    from repro_torch.federation import Federation
    fed = Federation(parties=2)   # device=None: the CUDA card
    fed.ingest(x_train, y_train)
    model = fed.fit(ForestParams(n_estimators=20, max_depth=8))
    preds = fed.predict(model, x_test)

Layers:
  * ``substrate``  — the substrate registry (SimulatedSubstrate in process,
    ShardedSubstrate over ``torch.distributed`` ranks, DistributedSubstrate
    party-per-process), resolved once per session through
    ``resolve_substrate``.
  * ``transport``  — length-prefixed msgpack wire protocol, retry/backoff,
    circuit breaker (the distributed substrate's fault-tolerance layer).
  * ``distributed`` / ``party_worker`` — coordinator + per-party worker
    processes speaking the transport protocol.
  * ``sharded``    — the sharded substrate's ranks: those workers joined
    into one process group, collectives rank to rank (``DistComm``).
  * ``programs``   — substrate-specialized fit/predict programs shared by
    the session and the serving engine.
  * ``estimator``  — the Estimator protocol every model family conforms to.
  * ``session``    — the Federation object that owns all of the above.
"""
from repro_torch.federation.distributed import (  # noqa: F401
    DistributedSubstrate, surviving_trees)
from repro_torch.federation.estimator import Estimator, FittedModel  # noqa: F401
from repro_torch.federation.session import Federation  # noqa: F401
from repro_torch.federation.substrate import (SUBSTRATES,  # noqa: F401
                                              ShardedSubstrate,
                                              SimulatedSubstrate,
                                              register_substrate,
                                              resolve_substrate)
from repro_torch.federation.transport import (  # noqa: F401
    CircuitBreaker, CircuitOpenError, PartyDead, PartyTimeout,
    PartyUnavailableError, RetryPolicy)
