"""The split-statistics histogram as a hand-written CUDA kernel for Hopper.

``csrc/histogram.cu`` replaces the TPU kernel of the JAX package
(``repro/kernels/histogram.py::histogram_pallas``); its header explains the
design.  It is built and bound as :mod:`repro_torch.kernels.build` says.

:func:`histogram_cuda` is the wrapper.  On a CUDA tensor it launches the
kernel or raises; on a CPU tensor it computes the kernel's plain version
(:func:`repro_torch.kernels.ref.histogram_ref`).  ``histogram_cuda.launches``
counts the kernel's launches, so a run can show that it went through the
kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import CudaLibrary

MAX_WARPS = 8       # warps per block, each with its own shared-memory slab


def _bind(lib: ctypes.CDLL) -> None:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.ff_histogram.argtypes = [vp, vp, vp, vp, i, i, i, i, i, i, i, vp]
    lib.ff_histogram.restype = i
    lib.ff_hist_max_smem.argtypes = [i]
    lib.ff_hist_max_smem.restype = i
    lib.ff_hist_error_string.argtypes = [i]
    lib.ff_hist_error_string.restype = ctypes.c_char_p


LIBRARY = CudaLibrary("histogram.cu", "ff_histogram", _bind)


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library."""
    return LIBRARY.load()


def launch_plan(n_level: int, n_bins: int, n_chan: int,
                smem_limit: int) -> tuple[int, int]:
    """(warps per block, node slots per tile) for one launch.

    The warp count depends on ``n_bins * n_chan`` alone, so a cell's
    summation order never depends on F or L (see csrc/histogram.cu).  The
    slot tile is the most slots whose slabs fit in ``smem_limit``, evened
    out over the tiles."""
    cell = n_bins * n_chan * 4                     # one slot of one slab
    n_warps = MAX_WARPS
    while n_warps > 1 and n_warps * cell > smem_limit:
        n_warps //= 2
    if n_warps * cell > smem_limit:
        raise ValueError(
            f"histogram kernel: one node slot of n_bins={n_bins} x "
            f"C={n_chan} float32 ({cell} B) exceeds the {smem_limit} B of "
            f"shared memory a block can use")
    per_tile = smem_limit // (n_warps * cell)
    n_tiles = -(-n_level // per_tile)
    return n_warps, -(-n_level // n_tiles)


def column_major(xb: torch.Tensor) -> torch.Tensor:
    """(N, F) uint8 bins laid out feature-major — the (N, F) view of a
    contiguous (F, N) tensor — as the kernel reads them.  A no-op for a
    tensor already in that layout."""
    if xb.dtype == torch.uint8 and xb.t().is_contiguous():
        return xb
    return xb.to(torch.uint8).t().contiguous().t()


def histogram_cuda(xb: torch.Tensor, seg: torch.Tensor, stats: torch.Tensor,
                   n_level: int, n_bins: int) -> torch.Tensor:
    """Split-statistics histogram: (n_level, F, n_bins, C) float32.

    Args:
      xb:    (N, F) uint8 bins, feature-major (see :func:`column_major`).
      seg:   (N,) int32 node slot; a slot outside [0, n_level) drops the
             sample.
      stats: (N, C) float32 contiguous label statistics.

    A CUDA tensor launches the kernel (and raises on what it does not take);
    a CPU tensor gets the plain version."""
    if not xb.is_cuda:
        return ref.histogram_ref(xb, seg, stats, n_level, n_bins)
    n, f = xb.shape
    dev = xb.device
    if seg.device != dev or stats.device != dev:
        raise ValueError(f"histogram_cuda: xb on {dev}, seg on {seg.device}, "
                         f"stats on {stats.device}")
    if xb.dtype != torch.uint8 or not xb.t().is_contiguous():
        raise ValueError("histogram_cuda: xb must be uint8 (N, F) with "
                         "contiguous (F, N) storage — see column_major()")
    if seg.dtype != torch.int32 or seg.shape != (n,) or not seg.is_contiguous():
        raise ValueError(f"histogram_cuda: seg must be contiguous int32 of "
                         f"shape ({n},), got {seg.dtype} {tuple(seg.shape)}")
    if (stats.dtype != torch.float32 or stats.dim() != 2
            or stats.shape[0] != n or not stats.is_contiguous()):
        raise ValueError(f"histogram_cuda: stats must be contiguous float32 "
                         f"of shape ({n}, C), got {stats.dtype} "
                         f"{tuple(stats.shape)}")
    c = stats.shape[1]
    if not (1 <= n_bins <= 256) or n_level < 1 or c < 1:
        raise ValueError(f"histogram_cuda: needs 1 <= n_bins <= 256, "
                         f"n_level >= 1, C >= 1; got n_bins={n_bins}, "
                         f"n_level={n_level}, C={c}")
    if max(n * max(f, 1), n * c, n_level * f * n_bins * c) >= 2**31:
        raise ValueError("histogram_cuda: sizes must stay below 2^31 elements")
    out = torch.empty((n_level, f, n_bins, c), dtype=torch.float32, device=dev)
    if f == 0:
        return out
    lib = load_library()
    with torch.cuda.device(dev):
        smem = lib.ff_hist_max_smem(dev.index if dev.index is not None
                                    else torch.cuda.current_device())
        if smem <= 0:
            raise RuntimeError(f"histogram_cuda: cannot read the shared-memory "
                               f"limit (CUDA error {-smem})")
        n_warps, tile = launch_plan(n_level, n_bins, c, smem)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ff_histogram(xb.data_ptr(), seg.data_ptr(), stats.data_ptr(),
                              out.data_ptr(), n, f, n_level, n_bins, c, tile,
                              n_warps, stream)
    if rc != 0:
        raise RuntimeError(f"histogram_cuda: launch failed: CUDA error {rc} "
                           f"({lib.ff_hist_error_string(rc).decode()})")
    histogram_cuda.launches += 1
    return out


histogram_cuda.launches = 0
