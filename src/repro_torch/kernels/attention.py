"""Flash attention (prefill) as a hand-written CUDA kernel for Hopper.

``csrc/flash_attention.cu`` replaces the TPU kernel of the JAX package
(``repro/kernels/flash_attention.py::flash_attention``); its header explains
the design.  It is built and bound as :mod:`repro_torch.kernels.build` says.
bfloat16 inputs run on the tensor cores (wgmma, TMA, P kept in registers);
float32 inputs run in full float32 on the CUDA cores.
:func:`attention_plan` lays out either route's launch.

:func:`flash_attention` is the wrapper, with the JAX kernel's signature and
layout.  On a CUDA tensor it launches the kernel or raises; on a CPU tensor
it computes the kernel's plain version
(:func:`repro_torch.kernels.ref.flash_attention_ref`).  Both go through the
custom op ``repro_torch::flash_attention`` under a dispatch mode, so a
fake tensor (``FakeTensorMode``: the dry run, ``launch/cases.py``) passes
through it with its output's shape, and :func:`attention_work` counts its
work.
``flash_attention.launches`` counts the kernel's launches, so a run can show
that it went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from repro_torch.kernels import ref
from repro_torch.kernels.build import CudaLibrary

HEAD_DIMS = (64, 112, 128)
DTYPES = (torch.float32, torch.bfloat16)
# Each route's tiles: (query rows per block, key rows per key/value tile,
# key/value tiles in shared memory at once, threads per block).  The kernel
# is compiled with them (LIBRARY's defines), so they are set here only.
TILES = {torch.bfloat16: (128, 128, 2, 288), torch.float32: (64, 64, 1, 256)}
F32_PAD = 68        # row stride (floats) of the float32 route's tiles


class AttnPlan(NamedTuple):
    """One launch of the kernel (see csrc/flash_attention.cu)."""
    route: str          # "f32 cuda cores" or "bf16 tensor cores"
    block_q: int        # query rows per block
    block_k: int        # key rows per key/value tile
    stages: int         # key/value tiles in shared memory at once
    threads: int        # per block
    q_tiles: int        # query tiles per batch-head
    grid: tuple[int, int]   # the launch's (x, y) blocks
    smem: int           # dynamic shared memory per block, bytes


@functools.lru_cache(maxsize=256)
def attention_plan(d: int, dtype: torch.dtype, sq: int, sk: int,
                   bh: int = 1) -> AttnPlan:
    """The launch for head dim ``d``, inputs of ``dtype``, ``sq`` query and
    ``sk`` key rows over ``bh`` batch-heads.

    bfloat16 goes to the tensor cores: 128 query rows per block (two
    consumer warpgroups of 64, the rows of a wgmma, and a producer warp),
    128-row key/value tiles in a ring of 2, all bf16 in shared memory from
    a 1024-byte aligned base, plus the mbarriers; the blocks are launched
    as one dimension of B*H x query tiles, query tile fastest.  float32
    keeps the CUDA-core route: 64-row tiles staged as float32 with rows
    padded to 68, on a (B*H, query tiles) grid.  A head dim of 112 is staged
    and multiplied as 128 on either route (the columns past 112 are zeros;
    csrc/flash_attention.cu's header), so its plan is D = 128's."""
    if d not in HEAD_DIMS or dtype not in DTYPES or min(sq, sk, bh) < 1:
        raise ValueError(f"attention_plan: d={d}, dtype={dtype}, sq={sq}, "
                         f"sk={sk}, bh={bh}")
    bq, bk, stages, threads = TILES[dtype]
    q_tiles = -(-sq // bq)
    dp = -(-d // 64) * 64       # the staged width
    if dtype == torch.bfloat16:
        # Q, then K and V per stage, then 1 + 4 * stages mbarriers
        smem = 1024 + 2 * dp * (bq + 2 * stages * bk) + 8 * (1 + 4 * stages)
        route, grid = "bf16 tensor cores", (bh * q_tiles, 1)
    else:
        smem = 4 * (2 * dp * F32_PAD + bk * F32_PAD)
        route, grid = "f32 cuda cores", (bh, q_tiles)
    return AttnPlan(route, bq, bk, stages, threads, q_tiles, grid, smem)


def _defines() -> tuple[str, ...]:
    """The tiles as the macros csrc/flash_attention.cu is compiled with."""
    keys = ("BQ", "BK", "STAGES", "THREADS")
    return (*(f"-DFF_{'TC' if dt == torch.bfloat16 else 'F32'}_{key}={val}"
              for dt, tiles in TILES.items() for key, val in zip(keys, tiles)),
            f"-DFF_F32_PAD={F32_PAD}")


def _bind(lib: ctypes.CDLL) -> None:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.ff_flash_attention.argtypes = [vp, vp, vp, vp, i, i, i, i, i, i, i,
                                       i, ctypes.c_float, i, i, i, vp]
    lib.ff_flash_attention.restype = i
    lib.ff_attn_set_smem.argtypes = [i, i, i]
    lib.ff_attn_set_smem.restype = i
    lib.ff_attn_error_string.argtypes = [i]
    lib.ff_attn_error_string.restype = ctypes.c_char_p


LIBRARY = CudaLibrary("flash_attention.cu", "ff_flash_attention", _bind,
                      _defines())
# the dynamic shared memory each (device, dtype, d) may use, as last set
_SMEM_SET: dict[tuple[int, torch.dtype, int], int] = {}


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library."""
    return LIBRARY.load()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """Blocked online-softmax attention, causal or sliding-window.

    Args:
      q:    (B, H, Sq, D); k, v: (B, H, Sk, D) — the GQA heads already
            repeated by the caller (``repeat_interleave`` over heads).
      causal, window: key j is visible to query i iff j <= qpos_i (when
            causal) and j > qpos_i - window (when a window is given), with
            qpos_i = i + Sk - Sq: the last query row is aligned with the last
            key row.
      scale: the scores' factor, D**-0.5 by default.
    Returns (B, H, Sq, D) in q's dtype; a row with no visible key is 0.

    A CUDA tensor launches the kernel: float32 or bfloat16, D in HEAD_DIMS
    (64, 112, 128; 112 through the 128 body, its scale 112**-0.5),
    all three contiguous and of one dtype, bfloat16 ones 16-byte aligned
    (TMA's rule) — anything else raises.  bfloat16 takes the tensor-core
    route (P rounded to bf16 for P·V), float32 the full-float32 route.  A
    CPU tensor gets the plain version.

    Under a dispatch mode (``FakeTensorMode``, ``op_analysis``'s counter)
    the call goes through the custom op ``repro_torch::flash_attention``
    (:func:`flash_attention_op`), whose fake implementation gives a fake
    tensor its output's shape without a launch, and whose work
    :func:`attention_work` counts; otherwise it calls the same
    implementation directly (the op's backend wrapper imports
    ``torch._dynamo`` on a process's first call, seconds in every spawned
    rank, and adds a dispatch a launch).

    The kernel has no backward pass (nor has the JAX package's Pallas
    kernel): with grad enabled and an input that requires grad it raises,
    on either device, rather than return an output that gradients cannot
    flow through.  Training attention is ``models/layers.py::attention``
    with ``phase="train"``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention has no backward pass: an input requires grad "
            "with grad enabled; training attention runs the plain "
            "_sdpa_chunked (models/layers.py::attention, phase='train')")
    if _get_current_dispatch_mode() is not None:
        return flash_attention_op(q, k, v, causal, window, scale)
    return _attend(q, k, v, causal, window, scale)


def _attend(q, k, v, causal: bool, window, scale) -> torch.Tensor:
    """The kernel on a CUDA tensor (or a raise), the plain version on a
    CPU tensor; no fallback."""
    if not q.is_cuda:
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       scale=scale).contiguous()
    return _launch(q, k, v, causal, window, scale)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool, window: Optional[int],
                       scale: Optional[float]) -> torch.Tensor:
    """:func:`flash_attention` as a custom op (:func:`_attend`)."""
    return _attend(q, k, v, causal, window, scale)


@flash_attention_op.register_fake
def _(q, k, v, causal, window, scale):
    return torch.empty_like(q, memory_format=torch.contiguous_format)


def attention_work(b: int, h: int, sq: int, sk: int, d: int, itemsize: int,
                   causal: bool, window: int | None) -> tuple[int, int]:
    """(operations, bytes) of one :func:`flash_attention` call: the two
    products over the (query, key) pairs the masks leave visible (4·D
    operations a pair), and q, k, v and the output each moved once."""
    # NumPy, not torch: the op counter calls this under FakeTensorMode
    qpos = np.arange(sq, dtype=np.int64) + (sk - sq)
    hi = np.minimum(qpos, sk - 1) if causal else np.full_like(qpos, sk - 1)
    lo = (np.maximum(qpos - window + 1, 0) if window is not None
          else np.zeros_like(qpos))
    pairs = int(np.maximum(hi - lo + 1, 0).sum())
    return 4 * b * h * d * pairs, itemsize * b * h * d * (2 * sq + 2 * sk)


def _launch(q, k, v, causal: bool, window, scale) -> torch.Tensor:
    """The checked operands' attention by the kernel on q's card."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be (B, H, S, D)")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if k.shape != (b, h, sk, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not agree")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: q on {q.device}, k on {k.device}, "
                         f"v on {v.device}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q, k, v must share one dtype of "
                         f"{DTYPES}, got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} is not one of "
                         f"{HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    if window is not None and abs(window) >= 2**30:
        raise ValueError(f"flash_attention: window {window} out of range")
    plan = attention_plan(d, q.dtype, sq, sk, b * h)
    if (b * h * max(sq, sk) * d >= 2**31 or plan.grid[0] >= 2**31
            or plan.grid[1] > 65535):
        raise ValueError("flash_attention: sizes out of range")
    is_bf16 = q.dtype == torch.bfloat16
    if is_bf16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: bfloat16 q, k, v must be 16-byte "
                         "aligned")
    out = torch.empty_like(q)
    lib = load_library()
    with torch.cuda.device(q.device):
        key = (q.device.index, q.dtype, d)
        if plan.smem > _SMEM_SET.get(key, 48 * 1024):
            _check(lib, lib.ff_attn_set_smem(int(is_bf16), d, plan.smem))
            _SMEM_SET[key] = plan.smem
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _check(lib, lib.ff_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h,
            sq, sk, d, int(is_bf16), int(causal), int(window is not None),
            0 if window is None else int(window),
            d ** -0.5 if scale is None else float(scale), *plan.grid,
            plan.smem, stream))
    flash_attention.launches += 1
    return out


def _check(lib: ctypes.CDLL, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"flash_attention: launch failed: CUDA error {rc} "
                           f"({lib.ff_attn_error_string(rc).decode()})")


flash_attention.launches = 0
