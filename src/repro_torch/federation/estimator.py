"""The Estimator protocol a federated model conforms to.

``Federation.fit`` returns a *fitted model handle* — the estimator instance
itself, carrying its learned state (``trees_`` for forests).  It speaks a
minimal surface:

  * ``fit(partition, y)``  — train on a VerticalPartition (core/party.py);
    returns self.
  * ``predict(x_test)``    — predict raw feature rows (N_t, F); the model
    re-bins / re-splits through the partition it was fitted with.
"""
from __future__ import annotations

from typing import Any, Protocol, runtime_checkable

import numpy as np


@runtime_checkable
class Estimator(Protocol):
    """Minimal train/infer surface of a federated model."""

    def fit(self, partition: Any, y: np.ndarray) -> "Estimator": ...

    def predict(self, x_test: np.ndarray) -> np.ndarray: ...


# A fitted model handle IS the estimator instance with learned state attached
# (Federation.fit's return type).
FittedModel = Estimator
