"""Federated logistic / linear regression (the paper's F-LR baseline).

Vertical-FL linear models: each party holds its feature block X_i and its
weight block w_i; the joint logit is  z = Σ_i X_i w_i + b  — one sum over
the party dimension per step, the gradients computed locally per block.
This is the [Hardy et al. 2017]-style baseline of the paper's Table 1
(without HE, as in the paper's trust model).

The party axis is an explicit leading dimension: the blocks are stacked,
zero-padded to the widest, into an (M, N, Fmax) tensor, and the JAX
package's ``psum`` over the party axis is a sum over dim 0.  Every party
keeps its own copy of the bias, as the JAX package's party stack does (the
copies are equal: each receives the same sum).  The steps run in float32,
one after another, as the JAX package's ``lax.scan`` does.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core.party import VerticalPartition
from repro_torch.core.prediction import _check_full_f32
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class LinearParams:
    """Spec for Federation.fit dispatch — mirrors FederatedLinear's knobs."""
    task: str = "classification"
    lr: float = 0.5
    steps: int = 400
    l2: float = 1e-4


def _joint_logit(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 comm=None) -> torch.Tensor:
    """(M, N) joint logit every party computes: the sum over parties of
    each block's ``x_i @ w_i`` (the one collective — through ``comm`` on a
    rank of the sharded substrate, where M is its own party), plus the
    party's bias."""
    _check_full_f32(x.device, "F-LR")
    z = torch.matmul(x, w[..., None])[..., 0].sum(0)
    if comm is not None:
        z = comm.psum(z)
    return z[None] + b[:, None]


def _spmd_fit(x: torch.Tensor, y: torch.Tensor, *, task: str, lr: float,
              steps: int, l2: float,
              comm=None) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (M, N, Fmax) standardized party blocks; y: (N,) shared labels.
    Returns the (M, Fmax) weight blocks and the (M,) biases."""
    m, n, f = x.shape
    w = torch.zeros((m, f), dtype=torch.float32, device=x.device)
    b = torch.zeros((m,), dtype=torch.float32, device=x.device)
    yf = y.to(torch.float32)
    xt = x.transpose(1, 2)
    for _ in range(steps):
        z = _joint_logit(x, w, b, comm)
        pred = torch.sigmoid(z) if task == "classification" else z
        err = (pred - yf) / n
        gw = torch.matmul(xt, err[..., None])[..., 0] + l2 * w  # local grads
        gb = err.sum(-1)
        w, b = w - lr * gw, b - lr * gb
    return w, b


def _spmd_predict(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                  task: str) -> torch.Tensor:
    """The shared (N,) prediction from the stacked blocks, weights and a
    bias."""
    z = _joint_logit(x, w, b.reshape(1))[0]
    if task == "classification":
        return (z > 0).to(torch.int32)
    return z


@dataclasses.dataclass
class FederatedLinear:
    """F-LR: logistic (classification) or linear (regression) regression.

    Conforms to the federation Estimator protocol: ``fit``/``predict``
    accept either per-party raw feature blocks (the legacy surface) or a
    VerticalPartition carrying ``raw_parts`` — the session path.
    """
    task: str = "classification"
    lr: float = 0.5
    steps: int = 400
    l2: float = 1e-4
    # execution substrate (federation.substrate); None -> simulated
    substrate: Any = None
    # where the model is fitted and predicted: None -> the CUDA card
    device: torch.device | str | None = None

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)

    @classmethod
    def from_params(cls, params: LinearParams, substrate=None,
                    **kw) -> "FederatedLinear":
        return cls(task=params.task, lr=params.lr, steps=params.steps,
                   l2=params.l2, substrate=substrate, **kw)

    def _sub(self):
        from repro_torch.federation.substrate import default_substrate
        return default_substrate(self.substrate)

    def _blocks(self, x) -> list[np.ndarray]:
        """Per-party raw feature blocks from any accepted input form."""
        if isinstance(x, VerticalPartition):
            if x.raw_parts is None:
                raise ValueError(
                    "this VerticalPartition carries no raw feature blocks "
                    "(built before make_vertical_partition kept them?)")
            self._partition = x
            return x.raw_parts
        if isinstance(x, np.ndarray) and x.ndim == 2:
            part = getattr(self, "_partition", None)
            if part is None:
                raise ValueError("raw-matrix input needs a partition: fit "
                                 "with a VerticalPartition first")
            return part.split_raw(x)
        return [np.asarray(b) for b in x]

    def _standardized(self, x_parts: list[np.ndarray]) -> np.ndarray:
        """(M, N, Fmax) stack of the blocks, standardized with the fit-time
        moments — the one owner of the normalize step of fit and predict."""
        return self._stack([(p - m) / s for p, m, s
                            in zip(x_parts, self._mu, self._sd)])

    def fit(self, x_parts, y: np.ndarray):
        """x_parts: per-party raw blocks (same N, varying F_i), or a
        VerticalPartition with raw_parts."""
        x_parts = self._blocks(x_parts)
        self._mu = [p.mean(0) for p in x_parts]
        self._sd = [p.std(0) + 1e-8 for p in x_parts]
        xs = torch.as_tensor(self._standardized(x_parts), device=self.device)
        yt = torch.as_tensor(np.asarray(y), device=self.device)

        def fn(x, yy):
            return _spmd_fit(x, yy, task=self.task, lr=self.lr,
                             steps=self.steps, l2=self.l2)
        # in process, or over a sharded mesh's ranks (a rank-only body);
        # the party-per-process substrate has no F-LR fit body (nor does
        # the JAX package's), so its program() raises
        from repro_torch.federation import sharded
        run = self._sub().jit(fn, 1, 1, sharded=sharded.linear_fit_spec(
            self.task, self.lr, self.steps, self.l2))
        self._w, self._b = (torch.as_tensor(a, device=self.device)
                            for a in run(xs, yt))
        return self

    def predict(self, x_parts) -> np.ndarray:
        from repro_torch.federation import programs
        sub = self._sub()
        xs = self._standardized(self._blocks(x_parts))
        if not getattr(sub, "host_operands", False):
            xs = torch.as_tensor(xs, device=self.device)
        run = programs.linear_predict_program(sub, self.task)
        out = run(xs, self._w, self._b[0] if self._b.ndim else self._b)
        return programs.party0(out)

    @staticmethod
    def _stack(parts: list[np.ndarray]) -> np.ndarray:
        fmax = max(p.shape[1] for p in parts)
        out = np.zeros((len(parts), parts[0].shape[0], fmax), np.float32)
        for i, p in enumerate(parts):
            out[i, :, : p.shape[1]] = p
        return out


def split_columns(x: np.ndarray, n_parties: int) -> list[np.ndarray]:
    return [np.asarray(b) for b in np.array_split(x, n_parties, axis=1)]
