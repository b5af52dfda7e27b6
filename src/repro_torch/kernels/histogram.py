"""The split-statistics histogram as a hand-written CUDA kernel for Hopper.

``csrc/histogram.cu`` replaces the TPU kernel of the JAX package
(``repro/kernels/histogram.py::histogram_pallas``); its header explains the
design.  It is built and bound as :mod:`repro_torch.kernels.build` says.

:func:`histogram_cuda` is the wrapper.  On a CUDA tensor it launches the
kernel or raises; on a CPU tensor it computes the kernel's plain version
(:func:`repro_torch.kernels.ref.histogram_ref`); under a dispatch mode
both go through the custom op ``repro_torch::histogram``.  ``histogram_cuda.launches``
counts the kernel's launches, so a run can show that it went through the
kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from repro_torch.kernels import ref
from repro_torch.kernels.build import CudaLibrary

WARPS = 8           # warps per block, each with a shared-memory slab of its own
MAX_CHUNKS = 64     # a launch cuts N into at most this many chunks
BLOCKS_PER_SM = 2   # the slot tile leaves room for this many blocks on an SM
STAGE_BYTES = 24576  # shared memory of one of a block's two staging buffers
MAX_PART = 2**26    # scratch floats of one launch's partial slabs, at most


def _bind(lib: ctypes.CDLL) -> None:
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ff_histogram.argtypes = [vp] * 6 + [ctypes.POINTER(i), f, vp]
    lib.ff_histogram.restype = i
    lib.ff_hist_max_smem.argtypes = [i]
    lib.ff_hist_max_smem.restype = i
    lib.ff_hist_set_smem.argtypes = [i]
    lib.ff_hist_set_smem.restype = i
    lib.ff_hist_error_string.argtypes = [i]
    lib.ff_hist_error_string.restype = ctypes.c_char_p


LIBRARY = CudaLibrary("histogram.cu", "ff_histogram", _bind)


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library."""
    return LIBRARY.load()


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _window(n_bytes: int) -> int:
    """Shared memory that stages ``n_bytes`` from any address in 16-byte
    pieces (csrc/histogram.cu ``window``)."""
    return _round_up(n_bytes, 16) + 16


class Plan(NamedTuple):
    """One launch of the kernel (see csrc/histogram.cu).

    ``chunk`` and ``phases`` fix every cell's summation order and come from
    N, B and C alone; the rest lays the work out on the card."""
    chunk: int            # samples per chunk (a multiple of 256)
    n_chunks: int
    phases: int           # warps that split one feature's 32-sample steps
    warps: int            # warps per block
    feat_per_block: int
    n_groups: int         # feature groups
    slot_tile: int        # node slots per block
    n_tiles: int
    groups_per_launch: int
    tiles_per_launch: int
    sub: int              # samples staged in shared memory at a time
    smem: int             # dynamic shared memory per block, bytes
    part: int             # scratch floats of one launch's partial slabs
    int_limit: int        # |stat| bound of the integer route: 2^24 / chunk

    @property
    def blocks(self) -> int:
        """Blocks of one (full) launch."""
        return self.n_chunks * self.groups_per_launch * self.tiles_per_launch

    @property
    def sum_depth(self) -> int:
        """Most roundings on the way from one sample's stat to its cell on
        the float route: the steps of its chunk (for node stats, of its
        phase, then the phases), then the chunks in order."""
        return -(-self.chunk // self.phases) + self.phases + self.n_chunks

    @property
    def gamma(self) -> float:
        """γ_d = d·u / (1 - d·u) for d = :attr:`sum_depth`, u = 2^-24: a
        float-route cell is within γ·Σ|stats| of its exact sum, whatever
        the signs (the error model of a sum of depth d)."""
        d = self.sum_depth * 2.0**-24
        return d / (1.0 - d)

    @property
    def launches(self) -> int:
        return (-(-self.n_groups // self.groups_per_launch)
                * -(-self.n_tiles // self.tiles_per_launch))


def chunk_len(n: int, n_bins: int, n_chan: int) -> int:
    """Samples per chunk: about 128 per (bin, channel) cell of a slot,
    within [2048, 16384], raised so that N spans at most MAX_CHUNKS chunks;
    a multiple of 256.  A function of N, B and C alone."""
    base = min(max(_round_up(n_bins * n_chan * 128, 256), 2048), 16384)
    return max(base, _round_up(-(-n // MAX_CHUNKS), 256))


@functools.lru_cache(maxsize=1024)
def launch_plan(n: int, n_feat: int, n_level: int, n_bins: int, n_chan: int,
                smem_limit: int) -> Plan:
    """The launch of one histogram over N samples, F features and L slots.

    The chunk, the warps and the phases depend on N, B and C (and the
    device's shared memory) alone, so a cell's summation order never depends
    on F or L (see csrc/histogram.cu).  The slot tile is the most slots
    whose slabs fit beside the staging in a BLOCKS_PER_SM-th of the shared
    memory, or in all of it where that holds no slot, evened out over the
    tiles.  Where the partial slabs of all F features would pass
    MAX_PART floats, the feature groups (and, where one group is too
    much, the slot tiles) are cut into several launches; that too leaves
    every cell's bits as they are."""
    bc = n_bins * n_chan
    chunk = chunk_len(n, n_bins, n_chan)
    node = n_bins == 1                        # the node stats' route

    def slab(slots: int) -> int:              # one warp's slab, bytes
        return _round_up(slots * bc, 4) * 4

    def staging(warps: int) -> tuple[int, int]:   # (samples, bytes)
        fpb = 1 if node else warps
        sub = max(256, STAGE_BYTES // (4 + 4 * n_chan + fpb) // 256 * 256)
        sub = min(sub, chunk)
        # two buffers of windows and the list of a tile's samples, as
        # csrc/histogram.cu lays them out
        return sub, (2 * (_window(4 * sub) + _window(4 * sub * n_chan)
                          + fpb * _window(sub)) + 4 * sub)

    warps = WARPS
    while warps > 1 and warps * slab(1) + staging(warps)[1] > smem_limit:
        warps //= 2
    sub, staged = staging(warps)
    if warps * slab(1) + staged > smem_limit:
        raise ValueError(
            f"histogram kernel: one node slot of n_bins={n_bins} x "
            f"C={n_chan} float32 ({4 * bc} B) exceeds the {smem_limit} B of "
            f"shared memory a block can use")
    budget = smem_limit // BLOCKS_PER_SM - 1024
    if warps * slab(1) + staged > budget:
        budget = smem_limit
    per_tile = (budget - staged) // (warps * 4 * bc)
    while warps * slab(per_tile) + staged > budget:
        per_tile -= 1
    n_tiles = -(-n_level // per_tile)
    tile = -(-n_level // n_tiles)
    phases = warps if node else 1
    fpb = warps // phases
    n_chunks = -(-n // chunk)
    n_groups = -(-n_feat // fpb)
    # scratch of one (group, tile): at most 64 chunks x 8 slabs of at most
    # the block's shared memory, below MAX_PART
    part = n_chunks * fpb * slab(tile) // 4 if n_chunks > 1 else 0
    tiles = n_tiles if part * n_tiles <= MAX_PART else MAX_PART // part
    groups = n_groups
    if part * tiles * groups > MAX_PART:
        groups = MAX_PART // (part * tiles)
    return Plan(chunk, n_chunks, phases, warps, fpb, n_groups, tile, n_tiles,
                groups, tiles, sub, warps * slab(tile) + staged,
                part * tiles * groups, 2**24 // chunk)


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
    a CPU tensor gets the plain version.  Under a dispatch mode
    (``FakeTensorMode``, ``op_analysis``'s counter) the call goes through
    the custom op ``repro_torch::histogram`` (:func:`histogram_op`): a fake
    tensor passes through it with its output's shape, and
    :func:`histogram_work` counts its work; otherwise it calls the same
    implementation directly, as ``attention.flash_attention`` does."""
    if _get_current_dispatch_mode() is not None:
        return histogram_op(xb, seg, stats, n_level, n_bins)
    return _histogram(xb, seg, stats, n_level, n_bins)


@torch.library.custom_op("repro_torch::histogram", mutates_args=())
def histogram_op(xb: torch.Tensor, seg: torch.Tensor, stats: torch.Tensor,
                 n_level: int, n_bins: int) -> torch.Tensor:
    """:func:`histogram_cuda` as a custom op (:func:`_histogram`)."""
    return _histogram(xb, seg, stats, n_level, n_bins)


def _histogram(xb, seg, stats, n_level: int, n_bins: int) -> torch.Tensor:
    """The kernel on a CUDA tensor (or a raise), the plain version on a CPU
    tensor; no fallback."""
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
    if f == 0 or n == 0:
        return torch.zeros((n_level, f, n_bins, c), dtype=torch.float32,
                           device=dev)
    index = xb.get_device()
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return _launch(xb, seg, stats, n_level, n_bins, index)
    return _launch(xb, seg, stats, n_level, n_bins, index)


def _launch(xb, seg, stats, n_level: int, n_bins: int,
            index: int) -> torch.Tensor:
    """The checked operands' histogram on CUDA device ``index``, the
    current device."""
    lib = load_library()
    (n, f), c = xb.shape, stats.shape[1]
    plan = launch_plan(n, f, n_level, n_bins, c, smem_limit(index))
    if max(plan.groups_per_launch, plan.tiles_per_launch) > 65535:
        raise ValueError(f"histogram_cuda: {plan} is too large a launch")
    if plan.smem > _SMEM_SET.get(index, 48 * 1024):
        _check(lib, lib.ff_hist_set_smem(plan.smem))
        _SMEM_SET[index] = plan.smem
    stream = torch.cuda.current_stream(index).cuda_stream
    part, ticket = _scratch(index, stream, plan.part,
                            plan.groups_per_launch * plan.tiles_per_launch)
    out = torch.empty((n_level, f, n_bins, c), dtype=torch.float32,
                      device=xb.device)
    per_launch = plan.groups_per_launch * plan.feat_per_block
    for f_lo in range(0, f, per_launch):
        for t_lo in range(0, plan.n_tiles, plan.tiles_per_launch):
            _check(lib, lib.ff_histogram(
                xb.data_ptr(), seg.data_ptr(), stats.data_ptr(),
                out.data_ptr(), part.data_ptr(), ticket.data_ptr(),
                _launch_ints(plan, n, f, n_level, n_bins, c, f_lo, t_lo),
                float(plan.int_limit), stream))
            histogram_cuda.launches += 1
    return out


histogram_cuda.launches = 0


@histogram_op.register_fake
def _(xb, seg, stats, n_level, n_bins):
    return stats.new_empty((n_level, xb.shape[1], n_bins, stats.shape[1]),
                           dtype=torch.float32)


def histogram_work(n: int, f: int, c: int, n_level: int, n_bins: int,
                   live: int | None = None) -> tuple[int, int]:
    """(operations, bytes) of one :func:`histogram_cuda` call: an add of
    each of C statistics of each of the ``live`` samples (those whose slot
    is in range; all N when not given) into one bin of each feature, and
    the bins, slots and statistics read and the histogram written once."""
    live = n if live is None else live
    return (live * f * c,
            n * f + 4 * n + 4 * n * c + 4 * n_level * f * n_bins * c)


@functools.lru_cache(maxsize=1024)
def _launch_ints(plan: Plan, n: int, f: int, n_level: int, n_bins: int,
                 c: int, f_lo: int, t_lo: int) -> ctypes.Array:
    """The integer arguments of one launch, as ``ff_histogram`` reads them."""
    f_hi = min(f, f_lo + plan.groups_per_launch * plan.feat_per_block)
    return (ctypes.c_int * 18)(
        n, f, f_lo, f_hi, t_lo, n_level, n_bins, c, plan.chunk, plan.phases,
        plan.feat_per_block, plan.slot_tile, plan.sub, plan.n_chunks,
        -(-(f_hi - f_lo) // plan.feat_per_block),
        min(plan.tiles_per_launch, plan.n_tiles - t_lo), plan.warps,
        plan.smem)


_SMEM_LIMIT: dict[int, int] = {}   # device -> opt-in shared memory per block
_SMEM_SET: dict[int, int] = {}     # device -> the kernel's dynamic smem limit
_SCRATCH: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}


def _check(lib: ctypes.CDLL, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"histogram_cuda: launch failed: CUDA error {rc} "
                           f"({lib.ff_hist_error_string(rc).decode()})")


def smem_limit(index: int) -> int:
    """Shared memory a block may opt into on CUDA device ``index``, bytes."""
    if index not in _SMEM_LIMIT:
        v = load_library().ff_hist_max_smem(index)
        if v <= 0:
            raise RuntimeError(f"histogram_cuda: cannot read the shared-memory "
                               f"limit (CUDA error {-v})")
        _SMEM_LIMIT[index] = v
    return _SMEM_LIMIT[index]


def _scratch(index: int, stream: int, n_part: int,
             n_ticket: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The partial slabs and the zeroed tickets of a launch, kept per device
    and stream and grown as needed.  Launches on one stream run in order,
    and each launch leaves its tickets at zero."""
    key = (index, stream)
    part, ticket = _SCRATCH.get(key, (None, None))
    dev = torch.device("cuda", index)
    if part is None or part.numel() < n_part:
        part = torch.empty(max(n_part, 1), dtype=torch.float32, device=dev)
    if ticket is None or ticket.numel() < n_ticket:
        ticket = torch.zeros(n_ticket, dtype=torch.int32, device=dev)
    _SCRATCH[key] = part, ticket
    return part, ticket


def reserve_scratch(index: int, stream: int,
                    shapes) -> tuple[torch.Tensor, torch.Tensor]:
    """The scratch of ``stream`` on CUDA device ``index``, grown now for
    launches of every ``(n, f, n_level, n_bins, c)`` in ``shapes``, and the
    kernel's shared memory opted into for the largest of them.

    For a CUDA graph captured on ``stream``: its launches keep the
    addresses returned here, so nothing may grow the scratch inside the
    capture, and the graph's owner holds these tensors for the graph's
    life, zeroes the tickets at each replay (as every launch leaves them)
    and hands the stream back with :func:`release_scratch`."""
    plans = [launch_plan(*s, smem_limit(index)) for s in shapes]
    smem = max(p.smem for p in plans)
    if smem > _SMEM_SET.get(index, 48 * 1024):
        lib = load_library()
        with torch.cuda.device(index):
            _check(lib, lib.ff_hist_set_smem(smem))
        _SMEM_SET[index] = smem
    return _scratch(index, stream, max(p.part for p in plans),
                    max(p.groups_per_launch * p.tiles_per_launch
                        for p in plans))


def release_scratch(index: int, stream: int) -> None:
    """Forget the scratch of ``stream`` on device ``index`` (a stream whose
    graphs are gone)."""
    _SCRATCH.pop((index, stream), None)
