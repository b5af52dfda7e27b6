"""Prediction planning (the leaf-compaction table) and, in ``engine.py``,
the checkpoint loader ``load_forest_trees``.  The JAX package's serving
engine and fleet are not ported yet."""
from repro_torch.serving.plan import (LeafTable, build_leaf_table,  # noqa: F401
                                      compaction_ratio)
