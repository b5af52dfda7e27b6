"""AdamW and the cosine learning-rate schedule, as the JAX package's
``train/optim.py`` writes them.

The update is the JAX package's, literally: float32 moments, bias
corrections from an int32 step counter, and ``p - lr·(update + wd·p)`` in
float32 cast back to the parameter's dtype, weight decay on every leaf
(norm scales too).  ``torch.optim.AdamW`` places eps and orders the decay
otherwise, so it would round differently; it is not used.  The state is
keyed by parameter name (``model.named_parameters()``), as the JAX state
mirrors the parameter pytree.
"""
from __future__ import annotations

import math
from collections.abc import Mapping

import torch
from torch import nn


def adamw_init(model: nn.Module) -> dict:
    """Zero float32 moments ``mu``, ``nu`` for each parameter, by name, and
    an int32 ``step`` of 0, on the model's devices."""
    mu = {n: torch.zeros_like(p, dtype=torch.float32)
          for n, p in model.named_parameters()}
    first = next(iter(mu.values()))
    return {"mu": mu,
            "nu": {n: torch.zeros_like(m) for n, m in mu.items()},
            "step": torch.zeros((), dtype=torch.int32, device=first.device)}


@torch.no_grad()
def adamw_update(model: nn.Module, grads: Mapping[str, torch.Tensor],
                 state: dict, *, lr, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.01) -> dict:
    """One AdamW step: the model's parameters are updated in place from
    ``grads`` (a tensor per parameter name, any float dtype); returns the
    new state.  ``lr`` is a float or a float32 scalar tensor (such as
    :func:`cosine_lr`'s)."""
    step = state["step"] + 1
    sf = step.to(torch.float32)
    c1 = 1.0 - b1 ** sf
    c2 = 1.0 - b2 ** sf
    mu_out, nu_out = {}, {}
    for name, p in model.named_parameters():
        gf = grads[name].to(torch.float32)
        mu = b1 * state["mu"][name] + (1 - b1) * gf
        nu = b2 * state["nu"][name] + (1 - b2) * gf * gf
        upd = (mu / c1) / (torch.sqrt(nu / c2) + eps)
        pf = p.to(torch.float32)
        pf = pf - lr * (upd + weight_decay * pf)
        p.copy_(pf.to(p.dtype))
        mu_out[name], nu_out[name] = mu, nu
    return {"mu": mu_out, "nu": nu_out, "step": step}


def cosine_lr(step, *, peak: float, warmup: int, total: int,
              floor_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``peak`` over ``warmup`` steps, then a cosine decay
    to ``floor_frac·peak`` at ``total``; float32."""
    sf = torch.as_tensor(step).to(torch.float32)
    warm = peak * sf / max(warmup, 1)
    prog = ((sf - warmup) / max(total - warmup, 1)).clamp(0.0, 1.0)
    cos = peak * (floor_frac + (1 - floor_frac) * 0.5
                  * (1 + torch.cos(math.pi * prog)))
    return torch.where(sf < warmup, warm, cos)
