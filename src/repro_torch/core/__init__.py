"""Federated Forest core — the paper's contribution on PyTorch tensors."""
from repro_torch.core.boosting import (BoostParams,  # noqa: F401
                                       FederatedBoosting, split_rounds,
                                       stack_rounds)
from repro_torch.core.fedlinear import (FederatedLinear,  # noqa: F401
                                        LinearParams, split_columns)
from repro_torch.core.forest import (FederatedForest,  # noqa: F401
                                     fit_federated_forest)
from repro_torch.core.party import (VerticalPartition,  # noqa: F401
                                    make_vertical_partition)
from repro_torch.core.tree import PartyTree  # noqa: F401
from repro_torch.core.types import ForestParams  # noqa: F401
