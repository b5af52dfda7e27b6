"""Histogram backend registry.

``histogram`` dispatches through ``BACKENDS``, a name -> callable registry:
  * ``cuda``    — the hand-written CUDA kernel (kernels/histogram.py), the
                  only histogram for tensors on the card;
  * ``scatter`` — ``index_add_`` over flat (node, feature, bin) bucket ids,
                  for tensors on the CPU;
  * ``ref``     — the einsum oracle (kernels/ref.py), CPU tensors only;
  * ``auto``    — resolves by the tensor's device: ``cuda`` for a CUDA
                  tensor, ``scatter`` for a CPU tensor.
A plain backend asked for on a CUDA tensor raises: it never stands in for
the kernel (on the card ``index_add_`` adds with float atomics, whose order
varies from run to run).  New backends register with
:func:`register_backend` and become selectable through
``ForestParams.hist_impl`` without touching tree.py.
"""
from __future__ import annotations

from typing import Callable, Protocol

import torch

from repro_torch.kernels import histogram as _hist_kernel
from repro_torch.kernels import ref as _ref


class HistogramFn(Protocol):
    def __call__(self, xb: torch.Tensor, seg: torch.Tensor,
                 stats: torch.Tensor, n_level: int,
                 n_bins: int) -> torch.Tensor: ...


BACKENDS: dict[str, HistogramFn] = {}
KERNEL_BACKENDS = ("cuda",)     # the backends that take tensors on the card


def register_backend(name: str) -> Callable[[HistogramFn], HistogramFn]:
    """Register a histogram implementation under ``name``.

    Implementations take ``(xb, seg, stats, n_level, n_bins)`` and return the
    ``(n_level, F, n_bins, C)`` float32 split-statistics tensor; samples with
    ``seg < 0`` must contribute nothing.
    """
    def deco(fn: HistogramFn) -> HistogramFn:
        BACKENDS[name] = fn
        return fn
    return deco


def resolve_backend(impl: str, device: torch.device | str) -> str:
    """Map ``impl`` onto a registry key for tensors on ``device``: ``auto``
    is the kernel on a CUDA device and ``scatter`` on the CPU; a plain
    backend on a CUDA device raises."""
    device = torch.device(device)
    if impl == "auto":
        return "cuda" if device.type == "cuda" else "scatter"
    if impl not in BACKENDS:
        raise ValueError(f"unknown impl {impl!r} (have "
                         f"{sorted(BACKENDS) + ['auto']})")
    if device.type == "cuda" and impl not in KERNEL_BACKENDS:
        raise ValueError(
            f"histogram impl {impl!r} is a plain CPU version; tensors on "
            f"{device} go through the CUDA kernel (impl 'cuda' or 'auto')")
    return impl


def available_backends() -> tuple[str, ...]:
    return tuple(sorted(BACKENDS))


def _flat_buckets(xb, seg, stats, n_level: int, n_bins: int):
    """Flattening of the scatter backend.

    Returns ``(flat, vals)``: a flat (node, feature, bin) bucket id per
    (sample, feature) — invalid samples (seg < 0) route to the single
    overflow slot ``n_level * F * n_bins`` — and the matching f32 stat rows."""
    n, f = xb.shape
    c = stats.shape[-1]
    seg = seg.long()
    base = (seg[:, None] * (f * n_bins)
            + torch.arange(f, device=xb.device)[None, :] * n_bins + xb.long())
    flat = torch.where(seg[:, None] >= 0, base, n_level * f * n_bins)
    vals = stats.to(torch.float32)[:, None, :].expand(n, f, c)
    return flat.reshape(-1), vals.reshape(-1, c)


@register_backend("scatter")
def _histogram_scatter(xb, seg, stats, n_level: int, n_bins: int):
    f, c = xb.shape[1], stats.shape[-1]
    flat, vals = _flat_buckets(xb, seg, stats, n_level, n_bins)
    out = torch.zeros((n_level * f * n_bins + 1, c), dtype=torch.float32,
                      device=xb.device)
    out.index_add_(0, flat, vals)
    return out[:-1].reshape(n_level, f, n_bins, c)


@register_backend("ref")
def _histogram_ref(xb, seg, stats, n_level: int, n_bins: int):
    return _ref.histogram_ref(xb, seg, stats, n_level, n_bins)


@register_backend("cuda")
def _histogram_cuda(xb, seg, stats, n_level: int, n_bins: int):
    """The kernel, after bringing the operands into the layout it reads (a
    no-op on the fit's path, which lays them out once per fit)."""
    return _hist_kernel.histogram_cuda(
        _hist_kernel.column_major(xb), seg.to(torch.int32).contiguous(),
        stats.to(torch.float32).contiguous(), n_level, n_bins)


def histogram(xb: torch.Tensor, seg: torch.Tensor, stats: torch.Tensor,
              n_level: int, n_bins: int, impl: str = "auto") -> torch.Tensor:
    """Split-statistics histogram: (n_level, F, n_bins, C) float32."""
    return BACKENDS[resolve_backend(impl, xb.device)](xb, seg, stats,
                                                      n_level, n_bins)
