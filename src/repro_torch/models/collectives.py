"""Autograd-aware collectives of the sharded LM (``models/parallel.py``).

Each is a ``torch.autograd.Function`` with an explicit backward over a
rank's ``federation/sharded.py::DistComm``, and each is skipped in a group
of one (``comm`` None or of one rank), so that a model at (data, model) =
(1, 1) runs the unsharded model's very operations.  GSPMD derives these
from the JAX package's specs; here they are written out:

  * :func:`copy_to_model` (Megatron's ``f``): the identity forward, the
    model axis's all-reduce backward — at the input of every
    column-parallel region (attention's ``wq wk wv``, the MLP's ``wg wu``,
    the MoE's router and experts, ``lm_head``), whose input gradient each
    rank holds only in part;
  * :func:`reduce_from_model` (``g``): the all-reduce forward, the identity
    backward — after every row-parallel product (``wo``, ``wd``, the MoE's
    combine) and the vocabulary-sharded lookup;
  * :func:`gather_last`: a tensor whose last dim is split over the model
    axis all-gathered forward, this rank's slice of its gradient backward
    — the vocabulary-sharded logits, and the VLM's patches projected by a
    column-split ``vision_proj``;
  * :func:`fsdp_matmul` / :func:`fsdp_gather`: a leaf sharded over the
    data axis (FSDP): forward all-gathers its shards, computes, and frees
    the gathered weight, saving only the shard (and the input); backward
    gathers it again and reduce-scatters the weight's gradient in float32
    over "data", averaged over the axis as every data-parallel gradient
    is;
  * :func:`batch_mean`: a mean over the data axis's ranks forward, the
    identity backward (each data rank's gradient is averaged over the axis
    afterwards) — the MoE's load-balance statistics over the whole batch;
  * :func:`gather_rows` / :func:`scatter_rows`: the data shards' rows
    all-gathered forward and their gradient reduce-scattered backward (a
    sum that keeps this rank's rows), and the reverse — the MoE's tokens
    and gates gathered for the experts a rank holds under ``expert_data``,
    and its partial combine of the whole batch's rows returned;
  * :func:`shared_grad`: the identity forward, the gradient divided by the
    model axis's size backward — for a value every model rank computes
    alike whose gradient the model axis then sums (the MoE's aux loss);
  * :func:`all_sum`: the all-reduce forward and backward — a statistic
    each rank sums over its own channels and every rank then uses on its
    own channels (the recurrent blocks' ``out_norm``, an RMS over the
    whole d_inner: ``models/ssm.py``), so that the gradient of the sum is
    the sum of every rank's.

Every rank of an axis runs the same collectives in the same order, in the
forward, in a remat's recompute and in the backward.  :data:`GATHERED`
counts the bytes of gathered weights alive on this process, and names the
leaves gathered.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class FSDP:
    """The leaves of a module sharded over the data axis: ``comm`` that
    axis's DistComm, ``dims`` leaf name -> the dimension its shards split."""

    comm: Any
    dims: dict


class LiveBytes:
    """Bytes of tensors alive on this process (each freed when its last
    reference goes), their peak, and the names of the leaves tracked,
    since :meth:`reset`."""

    def __init__(self):
        self.live = 0
        self.peak = 0
        self.names: set = set()

    def track(self, t: torch.Tensor, name: str = "") -> torch.Tensor:
        n = t.numel() * t.element_size()
        self.live += n
        self.peak = max(self.peak, self.live)
        self.names.add(name)
        weakref.finalize(t, self._free, n)
        return t

    def _free(self, n: int) -> None:
        self.live -= n

    def reset(self) -> None:
        self.peak = self.live
        self.names = set()


GATHERED = LiveBytes()        # full weights gathered by the FSDP functions


def _one(comm) -> bool:
    return comm is None or comm.n_parties == 1


def _gather(shard: torch.Tensor, fsdp: FSDP, name: str) -> torch.Tensor:
    return GATHERED.track(
        fsdp.comm.all_gather_cat(shard.detach(), fsdp.dims[name]), name)


def _grad_shard(gw: torch.Tensor, dim: int, comm) -> torch.Tensor:
    """A full weight's gradient of this rank's rows, reduce-scattered in
    float32 over the data axis and averaged over it."""
    return comm.reduce_scatter(gw.float(), dim).div_(comm.n_parties)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_reduce(g), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, comm):
        return comm.all_reduce(y)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, comm):
        ctx.comm, ctx.n = comm, t.shape[-1]
        return comm.all_gather_cat(t, -1)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.comm.party_index * ctx.n
        return g[..., lo:lo + ctx.n].contiguous(), None


class _FSDPGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, fsdp, name):
        ctx.fsdp, ctx.name = fsdp, name
        return _gather(shard, fsdp, name)

    @staticmethod
    def backward(ctx, g):
        return (_grad_shard(g, ctx.fsdp.dims[ctx.name], ctx.fsdp.comm), None,
                None)


def _product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for a (in, out) matrix, ``torch.bmm`` for an (E, in, out)
    stack: the unsharded model's operations."""
    return torch.bmm(x, w) if w.dim() == 3 else x @ w


class _FSDPMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard, fsdp, name):
        ctx.fsdp, ctx.name = fsdp, name
        ctx.save_for_backward(x, shard)
        return _product(x, _gather(shard, fsdp, name))

    @staticmethod
    def backward(ctx, gy):
        x, shard = ctx.saved_tensors
        w = _gather(shard, ctx.fsdp, ctx.name)
        gx = None
        if ctx.needs_input_grad[0]:
            gx = _product(gy, w.transpose(-1, -2))
        if w.dim() == 3:
            gw = torch.bmm(x.transpose(1, 2), gy)
        else:
            gw = x.flatten(0, -2).t() @ gy.flatten(0, -2)
        del w
        return (gx, _grad_shard(gw, ctx.fsdp.dims[ctx.name], ctx.fsdp.comm),
                None, None)


class _BatchMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, comm):
        return comm.all_reduce(t).div_(comm.n_parties)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, comm):
        ctx.comm = comm
        return comm.all_gather_cat(t, 0)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.reduce_scatter(g, 0), None


class _ScatterRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, comm):
        ctx.comm = comm
        return comm.reduce_scatter(t, 0)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_gather_cat(g, 0), None


class _SharedGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, comm):
        ctx.n = comm.n_parties
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, comm):
        ctx.comm = comm
        return comm.all_reduce(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_reduce(g), None


def copy_to_model(x: torch.Tensor, comm) -> torch.Tensor:
    return x if _one(comm) else _CopyToModel.apply(x, comm)


def reduce_from_model(y: torch.Tensor, comm) -> torch.Tensor:
    return y if _one(comm) else _ReduceFromModel.apply(y, comm)


def gather_last(t: torch.Tensor, comm) -> torch.Tensor:
    """Every model rank's columns (last dim) of ``t`` in rank order;
    backward, this rank's columns of the gradient."""
    return t if _one(comm) else _GatherLast.apply(t, comm)


def batch_mean(t: torch.Tensor, comm) -> torch.Tensor:
    return t if _one(comm) else _BatchMean.apply(t, comm)


def shared_grad(t: torch.Tensor, comm) -> torch.Tensor:
    return t if _one(comm) else _SharedGrad.apply(t, comm)


def all_sum(t: torch.Tensor, comm) -> torch.Tensor:
    """The sum of every rank's ``t``; backward, the sum of every rank's
    gradient of it."""
    return t if _one(comm) else _AllSum.apply(t, comm)


def gather_rows(t: torch.Tensor, comm) -> torch.Tensor:
    """Every rank's rows of ``t`` in rank order; backward, the sum over the
    ranks of the gradient of this rank's rows."""
    return t if _one(comm) else _GatherRows.apply(t, comm)


def scatter_rows(t: torch.Tensor, comm) -> torch.Tensor:
    """This rank's share of the rows of the ranks' summed ``t``; backward,
    every rank's gradient of its share gathered."""
    return t if _one(comm) else _ScatterRows.apply(t, comm)


def _sharded(module, name: str) -> bool:
    return module.fsdp is not None and name in module.fsdp.dims


def weight(module, name: str) -> torch.Tensor:
    """Leaf ``name`` of ``module`` whole over the data axis: its shards
    gathered (:class:`_FSDPGather`) when it is sharded there."""
    w = getattr(module, name)
    if not _sharded(module, name):
        return w
    return _FSDPGather.apply(w, module.fsdp, name)


def matmul(module, name: str, x: torch.Tensor) -> torch.Tensor:
    """``x @ leaf`` (``torch.bmm`` for an expert stack) of ``module``'s
    leaf ``name``; through :class:`_FSDPMatmul` when the leaf is sharded
    over the data axis, which keeps no gathered weight for the backward."""
    w = getattr(module, name)
    if not _sharded(module, name):
        return _product(x, w)
    return _FSDPMatmul.apply(x, w, module.fsdp, name)
