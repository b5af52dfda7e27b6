"""The training step: microbatched gradient accumulation, then AdamW.

The port of the JAX package's ``train/step.py``.  A global batch that does
not fit at once is split into microbatches whose float32 gradients are
summed and averaged; one microbatch takes one backward pass with the
gradients in the parameters' dtype.  Eager PyTorch (no ``torch.compile``);
remat follows ``cfg.remat`` inside ``forward_train``.

The same step trains a model sharded for training
(``models/parallel.py::shard_model(..., mode="train")``) on a rank's rows
of the batch: its ``layout`` then reduces the gradients of the leaves it
holds whole over the mesh's axes, and averages the loss and CE over the
data axis, before AdamW updates the rank's slices.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer
from repro_torch.train import optim


def accumulate_grads(model, batch: dict, micro_batch: int = 0):
    """``(names, grads, metrics)`` of one step's backward passes over
    ``batch``: the gradient of each parameter (by name) of the mean loss
    over the microbatches of ``micro_batch`` rows (0: one pass), in the
    parameters' dtype after one pass, float32 accumulated after several;
    ``metrics`` the float32 ``loss``, ``ce`` and ``aux`` averaged over the
    microbatches.  A sharded model's ``layout`` reduces them over the
    mesh."""
    model.requires_grad_(True)
    names, params = zip(*model.named_parameters())

    def one_grad(mb):
        loss, (ce, aux) = transformer.lm_loss(model, mb)
        # zeros for a leaf the loss does not reach: a model rank's empty
        # share of heads (models/parallel.py::head_run)
        grads = torch.autograd.grad(loss, params, materialize_grads=True)
        return loss.detach(), ce.detach(), aux.detach(), grads

    b = batch["tokens"].shape[0]
    mb_size = micro_batch or b
    n_micro = max(b // mb_size, 1)
    if n_micro == 1:
        loss, ce, aux, grads = one_grad(batch)
    else:
        if b % mb_size:
            raise ValueError(f"batch {b} is no multiple of micro_batch "
                             f"{mb_size}")
        mbs = {k: v.reshape(n_micro, mb_size, *v.shape[1:])
               for k, v in batch.items()}
        dev = batch["tokens"].device
        grads = [torch.zeros(p.shape, dtype=torch.float32,
                             device=p.device) for p in params]
        loss, ce, aux = (torch.zeros((), dtype=torch.float32, device=dev)
                         for _ in range(3))
        for i in range(n_micro):
            l_i, c_i, a_i, g_i = one_grad({k: v[i] for k, v in mbs.items()})
            for a, g in zip(grads, g_i):
                a.add_(g.to(torch.float32))
            loss, ce, aux = loss + l_i, ce + c_i, aux + a_i
            del g_i
        grads = [g.div_(n_micro) for g in grads]
        loss, ce, aux = loss / n_micro, ce / n_micro, aux / n_micro
    if model.layout is not None:
        grads = model.layout.sync_grads(names, grads)
        loss, ce, aux = model.layout.data_average(loss, ce, aux)
    return names, grads, {"loss": loss, "ce": ce, "aux": aux}


def make_train_step(cfg: ArchConfig, *, micro_batch: int = 0,
                    lr: float = 3e-4):
    """Returns ``train_step(model, opt_state, batch) -> (model, opt_state,
    metrics)``: the model's parameters are made to require grad and
    updated in place, ``metrics`` holds the float32 ``loss`` and ``ce``
    (averaged over the microbatches, as the JAX step averages them) and
    the MoE's ``aux``."""

    def train_step(model, opt_state, batch):
        if model.cfg != cfg:
            raise ValueError(f"the step was made for {cfg.name}, the model "
                             f"is {model.cfg.name} (or another variant)")
        names, grads, metrics = accumulate_grads(model, batch, micro_batch)
        opt_state = optim.adamw_update(model, dict(zip(names, grads)),
                                       opt_state, lr=lr)
        return model, opt_state, metrics

    return train_step
