"""Serving engines.  For now only :func:`load_forest_trees`, which restores
the forest a checkpoint holds; the bucketed serving engine of the JAX
package's ``repro.serving.engine`` lands in this module later."""
from __future__ import annotations

import torch

from repro_torch import convert
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.core.tree import PartyTree
from repro_torch.device import resolve_device


def load_forest_trees(ckpt_dir: str, step: int | None = None,
                      device: torch.device | str | None = None) -> PartyTree:
    """Restore a fitted PartyTree stack (leading (M, T, ...) axes) from a
    ckpt/checkpoint.py snapshot — the artifact ``fit_resumable`` and
    ``Federation.save`` write, in either package — onto ``device`` (None:
    the CUDA card), each field in its PartyTree dtype.

    PartyTree is a NamedTuple, so its checkpoint keys are the field names
    (".is_leaf", ".leaf_stats", ...) — enough to rebuild it without a
    ``like`` tree."""
    device = resolve_device(device)
    if step is None:
        step = ckpt.latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    flat = ckpt.peek_checkpoint(ckpt_dir, step)
    keys = [f".{name}" for name in PartyTree._fields]
    if sorted(flat) != sorted(keys):
        raise ValueError(
            f"checkpoint at {ckpt_dir} step {step} is not a bare PartyTree "
            f"(keys {sorted(flat)})")
    return convert.party_trees_from_numpy(
        {name: flat[f".{name}"] for name in PartyTree._fields}, device)
