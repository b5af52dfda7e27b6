"""Federated Forest core — the paper's contribution on PyTorch tensors."""
from repro_torch.core.forest import FederatedForest  # noqa: F401
from repro_torch.core.party import (VerticalPartition,  # noqa: F401
                                    make_vertical_partition)
from repro_torch.core.tree import PartyTree  # noqa: F401
from repro_torch.core.types import ForestParams  # noqa: F401
