"""Synthetic tabular datasets and metrics."""
from repro_torch.data.metrics import (accuracy, f1_binary,  # noqa: F401
                                      rmse, ztest_two_sample)
from repro_torch.data.tabular import (DATASETS, DatasetSpec,  # noqa: F401
                                      load_dataset, make_classification,
                                      make_party_views, make_regression,
                                      train_test_split)
