"""Counting a step's work op by op: the port's counterpart of the JAX
package's ``hlo_analysis.py``.

The JAX package parses a compiled program's optimized HLO and multiplies
each loop body by its trip count.  The port's steps run eagerly, one
dispatched op at a time, in Python loops over layers, microbatches and
time steps, so every op is seen as often as it runs: :class:`OpCounter`,
a ``TorchDispatchMode``, counts over a step

  * FLOPs of every product (``mm``, ``addmm``, ``bmm``, ``baddbmm``, a
    convolution), 2·M·N·K, by the inputs' dtype — the HLO analysis's
    2·prod(result)·prod(contracting dims) — and of the two hand-written
    kernels by their own formulas (``kernels/attention.py::
    attention_work``, ``kernels/histogram.py::histogram_work``), which
    ``torch.library`` custom ops make visible here;
  * bytes read and written by every dispatched op: each tensor operand
    and result once (a view moves nothing; a gather-like op reads what
    it writes).  Eager ops are not fused, so this is the traffic the card
    moves, not a proxy;
  * peak live bytes: every storage alive at once, the step's arguments
    included (:meth:`OpCounter.track`) — the counterpart of XLA's
    ``memory_analysis``;
  * the collectives, through the comms that a rank's model holds
    (:class:`FakeComm` stands in for ``federation/sharded.py::DistComm``):
    per kind the rounds and bytes that ``DistComm`` would move
    (:class:`CollectiveTally`).

It works on real tensors and, unchanged, under ``FakeTensorMode``, where
no op computes: ``launch/cases.py`` runs a rank of a 256- or 512-rank mesh
so in one CPU process.
"""
from __future__ import annotations

import collections
import math
import weakref
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch import roofline

aten = torch.ops.aten

_PRODUCTS = {aten.mm.default, aten.addmm.default, aten.bmm.default,
             aten.baddbmm.default}
_CONVS = {aten.convolution.default, aten._convolution.default}
# ops that read no more than they write (what a slice of their input is)
_GATHERS = {aten.index_select.default, aten.embedding.default,
            aten.gather.default, aten.index.Tensor, aten.slice.Tensor,
            aten.select.int}
# ops that write their result without reading it, or read only the source
_WRITES = {aten.zero_.default, aten.fill_.Scalar, aten.copy_.default}
_ALLOCS = {aten.empty.memory_format, aten.empty_strided.default,
           aten.empty_like.default, aten.new_empty.default,
           aten.new_empty_strided.default}


_COMPOSITE: dict = {}


def _composite(func) -> bool:
    """Whether ``func`` has a CompositeImplicitAutograd kernel (cached)."""
    got = _COMPOSITE.get(func)
    if got is None:
        got = _COMPOSITE[func] = torch._C._dispatch_has_kernel_for_dispatch_key(
            func.name(), "CompositeImplicitAutograd")
    return got


def _tensors(values) -> list:
    """The tensors among ``values``, one level of lists and tuples deep (an
    op's arguments and results)."""
    out = []
    for v in values:
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            out.extend(t for t in v if isinstance(t, torch.Tensor))
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _dtype(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _conv_flops(args, out: torch.Tensor) -> int:
    """2 · outputs · (input channels of a group × kernel taps)."""
    w = args[1]
    return 2 * out.numel() * (w.shape[1] * math.prod(w.shape[2:]))


class CollectiveTally:
    """Per collective kind: rounds, bytes sent and received (as
    ``DistComm`` counts them), bus bytes (what a ring moves through each
    rank's link: all-reduce 2(m-1)/m of the buffer, all-gather and
    reduce-scatter (m-1)/m of the whole) and the seconds those take over
    the group's slowest link (``roofline.link_rate``)."""

    def __init__(self):
        self.kinds: dict[str, dict[str, float]] = {}

    def add(self, kind: str, sent: int, received: int, bus: float,
            ranks) -> None:
        slot = self.kinds.setdefault(kind, {"count": 0, "bytes_sent": 0,
                                            "bytes_received": 0,
                                            "bytes": 0.0, "seconds": 0.0})
        slot["count"] += 1
        slot["bytes_sent"] += sent
        slot["bytes_received"] += received
        slot["bytes"] += bus
        rate = roofline.link_rate(ranks)
        if bus and rate:
            slot["seconds"] += bus / rate

    @property
    def seconds(self) -> float:
        return sum(v["seconds"] for v in self.kinds.values())

    def detail(self) -> dict:
        return {k: dict(v) for k, v in self.kinds.items()}


class FakeComm:
    """A rank's collective endpoint without a process group: the interface
    of ``federation/sharded.py::DistComm`` that the sharded LM and the
    sharded substrate call, returning tensors of the right shapes (no
    values: it serves fake tensors) and tallying in ``tally`` what
    ``DistComm`` would have sent on ``backend``, each collective over the
    world ranks ``ranks`` (its group, for the link it crosses).  ``axes``
    holds the other axes' comms, as ``DistComm``'s does."""

    def __init__(self, ranks, party_index: int, tally: CollectiveTally, *,
                 rank: int = 0, device="cuda", backend: str = "nccl"):
        self.ranks = tuple(ranks)
        self.party_index = int(party_index)
        self.n_parties = len(self.ranks)
        self.tally = tally
        self.rank = int(rank)
        self.device = torch.device(device)
        self.backend = backend
        self.axes: dict[str, "FakeComm"] = {}

    def _round(self, arrays, kind: str):
        m = self.n_parties
        n = sum(_nbytes(t) for t in arrays)
        self.tally.add(kind, n, m * n if n else 0, (m - 1) * n, self.ranks)
        out = [t.new_empty((m,) + tuple(t.shape)) for t in arrays]
        if kind == "psum":
            out = [o.sum(0, dtype=t.dtype) for o, t in zip(out, arrays)]
        return out

    def all_gather(self, *arrays):
        out = self._round(arrays, "all_gather")
        return out[0] if len(arrays) == 1 else out

    def psum(self, *arrays):
        out = self._round(arrays, "psum")
        return out[0] if len(arrays) == 1 else out

    def all_gather_cat(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        if self.n_parties == 1:
            return t
        return torch.cat(self.all_gather(t).unbind(0), dim)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        m = self.n_parties
        if m == 1:
            return t
        n = _nbytes(t)
        self.tally.add("all_reduce", n, n, 2 * (m - 1) / m * n, self.ranks)
        return torch.clone(t, memory_format=torch.contiguous_format)

    def reduce_scatter(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        m = self.n_parties
        if m == 1:
            return t
        if t.shape[dim] % m:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                             f"over {m} ranks")
        n = _nbytes(t)
        got = n // m if self.backend == "nccl" else n
        self.tally.add("reduce_scatter", n, got, (m - 1) / m * n, self.ranks)
        k = t.shape[dim] // m
        return t.narrow(dim, self.party_index * k, k).contiguous().clone()


class OpCounter(TorchDispatchMode):
    """Counts FLOPs, bytes and live bytes of every op dispatched while it
    is active (module docstring), and holds the :class:`CollectiveTally`
    that a step's :class:`FakeComm` s fill (``collectives``).

    ``flops`` and ``flops_by_dtype``, ``bytes``, ``calls`` (op name ->
    count), ``kernel_calls`` (custom op name -> count), ``live_bytes``
    and ``peak_bytes`` (and each marked region's peak, ``marks``)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.flops_by_dtype: dict[str, int] = collections.Counter()
        self.bytes = 0
        self.calls: dict[str, int] = collections.Counter()
        self.kernel_calls: dict[str, int] = collections.Counter()
        self.kernel_flops: dict[str, int] = collections.Counter()
        self.collectives = CollectiveTally()
        self.live_bytes = 0
        self.peak_bytes = 0
        self.marks: dict[str, int] = {}
        self._held: set[int] = set()

    # ----------------------------------------------------------- live bytes
    def track(self, *trees) -> None:
        """Count the storages of every tensor in ``trees`` (nested lists,
        tuples, dicts, modules) as live from now until each is freed."""
        for tree in trees:
            if isinstance(tree, torch.nn.Module):
                tree = list(tree.parameters()) + list(tree.buffers())
            for t in tree_flatten(tree)[0]:
                if isinstance(t, torch.Tensor):
                    self._hold(t)

    def _hold(self, t: torch.Tensor) -> None:
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        key = id(st)
        if key in self._held:
            return
        n = st.nbytes()
        self._held.add(key)
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key, n)

    def _free(self, key: int, n: int) -> None:
        self._held.discard(key)
        self.live_bytes -= n

    def mark(self, region: str) -> None:
        """Keep the peak since the last mark as ``region``'s (``marks``:
        the largest, where a region is marked more than once), and start
        the next region's from the bytes alive."""
        self.marks[region] = max(self.marks.get(region, 0), self.peak_bytes)
        self.peak_bytes = self.live_bytes

    # ----------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "prim":       # metadata (a tensor's device)
            return func(*args, **kwargs)
        if _composite(func):
            # a composite op (``matmul``, ``einsum``, ``reshape``: met as
            # such where autograd is off) counts as the ops it is made of
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        ins = _tensors(args) + (_tensors(kwargs.values()) if kwargs else [])
        outs = _tensors((out,))
        for t in ins:
            self._hold(t)
        for t in outs:
            self._hold(t)
        self._count(func, args, ins, outs)
        return out

    def _count(self, func, args, ins, outs) -> None:
        name = func.name()
        self.calls[name] += 1
        ns = func.namespace
        if ns in ("c10d", "_c10d_functional") or func in _ALLOCS:
            return
        if ns == "repro_torch":
            self._kernel(func, args, outs)
        elif func in _PRODUCTS:
            a, b = args[-2], args[-1]
            f = 2 * math.prod(a.shape) * b.shape[-1]
            self.flops += f
            self.flops_by_dtype[_dtype(a)] += f
        elif func in _CONVS:
            f = _conv_flops(args, outs[0])
            self.flops += f
            self.flops_by_dtype[_dtype(args[0])] += f
        if func.is_view:
            return
        if func in _GATHERS:
            self.bytes += 2 * sum(_nbytes(t) for t in outs)
        elif func in _WRITES:
            self.bytes += sum(_nbytes(t) for t in ins[1:] + outs)
        else:
            self.bytes += sum(_nbytes(t) for t in ins + outs)

    def _kernel(self, func, args, outs) -> None:
        """A hand-written kernel's custom op: its work by its formula."""
        from repro_torch.kernels import attention, histogram
        name = func.name()
        self.kernel_calls[name] += 1
        if name == "repro_torch::flash_attention":
            q, k, _, causal, window = args[:5]
            b, h, sq, d = q.shape
            f, _ = attention.attention_work(b, h, sq, k.shape[2], d,
                                            q.element_size(), causal, window)
            dt = _dtype(q)
        else:
            xb, _, stats, n_level, n_bins = args[:5]
            f, _ = histogram.histogram_work(xb.shape[0], xb.shape[1],
                                            stats.shape[1], n_level, n_bins)
            dt = "float32"
        self.kernel_flops[name] += f
        self.flops += f
        self.flops_by_dtype[dt] += f


def count(fn, *args, counter: Optional[OpCounter] = None, **kwargs):
    """``fn(*args, **kwargs)`` under an :class:`OpCounter` (``counter``,
    or a new one): (its result, the counter)."""
    counter = counter or OpCounter()
    with counter:
        out = fn(*args, **kwargs)
    return out, counter
