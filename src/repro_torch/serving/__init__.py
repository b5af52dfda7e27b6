"""Prediction planning (the leaf-compaction table).  The serving engine and
fleet of the JAX package are not ported yet."""
from repro_torch.serving.plan import (LeafTable, build_leaf_table,  # noqa: F401
                                      compaction_ratio)
