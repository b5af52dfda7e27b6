"""Synthetic tabular datasets and metrics."""
from repro_torch.data.metrics import accuracy, rmse  # noqa: F401
from repro_torch.data.tabular import (make_classification,  # noqa: F401
                                      make_regression, train_test_split)
