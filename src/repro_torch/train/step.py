"""The training step: microbatched gradient accumulation, then AdamW.

The port of the JAX package's ``train/step.py``.  A global batch that does
not fit at once is split into microbatches whose float32 gradients are
summed and averaged; one microbatch takes one backward pass with the
gradients in the parameters' dtype.  Eager PyTorch (no ``torch.compile``);
remat follows ``cfg.remat`` inside ``forward_train``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer
from repro_torch.train import optim


def make_train_step(cfg: ArchConfig, *, micro_batch: int = 0,
                    lr: float = 3e-4):
    """Returns ``train_step(model, opt_state, batch) -> (model, opt_state,
    metrics)``: the model's parameters are made to require grad and
    updated in place, ``metrics`` holds the float32 ``loss`` and ``ce``
    (averaged over the microbatches, as the JAX step averages them)."""

    def one_grad(model, params, mb):
        loss, (ce, _) = transformer.lm_loss(model, mb)
        grads = torch.autograd.grad(loss, params)
        return loss.detach(), ce.detach(), grads

    def train_step(model, opt_state, batch):
        if model.cfg != cfg:
            raise ValueError(f"the step was made for {cfg.name}, the model "
                             f"is {model.cfg.name} (or another variant)")
        model.requires_grad_(True)
        names, params = zip(*model.named_parameters())
        b = batch["tokens"].shape[0]
        mb_size = micro_batch or b
        n_micro = max(b // mb_size, 1)
        if n_micro == 1:
            loss, ce, grads = one_grad(model, params, batch)
        else:
            if b % mb_size:
                raise ValueError(f"batch {b} is no multiple of micro_batch "
                                 f"{mb_size}")
            mbs = {k: v.reshape(n_micro, mb_size, *v.shape[1:])
                   for k, v in batch.items()}
            dev = batch["tokens"].device
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in params]
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            ce = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(n_micro):
                l_i, c_i, g_i = one_grad(model, params,
                                         {k: v[i] for k, v in mbs.items()})
                for a, g in zip(grads, g_i):
                    a.add_(g.to(torch.float32))
                loss, ce = loss + l_i, ce + c_i
                del g_i
            grads = [g.div_(n_micro) for g in grads]
            loss, ce = loss / n_micro, ce / n_micro
        opt_state = optim.adamw_update(model, dict(zip(names, grads)),
                                       opt_state, lr=lr)
        return model, opt_state, {"loss": loss, "ce": ce}

    return train_step
