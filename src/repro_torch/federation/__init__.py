"""Federation session API — one entry point for the federated lifecycle.

    from repro_torch.federation import Federation
    fed = Federation(parties=2)   # device=None: the CUDA card
    fed.ingest(x_train, y_train)
    model = fed.fit(ForestParams(n_estimators=20, max_depth=8))
    preds = fed.predict(model, x_test)
"""
from repro_torch.federation.estimator import Estimator, FittedModel  # noqa: F401
from repro_torch.federation.session import Federation  # noqa: F401
from repro_torch.federation.substrate import (SUBSTRATES,  # noqa: F401
                                              SimulatedSubstrate,
                                              resolve_substrate)
