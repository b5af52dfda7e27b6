"""Flash attention (prefill) as a hand-written CUDA kernel for Hopper.

``csrc/flash_attention.cu`` replaces the TPU kernel of the JAX package
(``repro/kernels/flash_attention.py::flash_attention``); its header explains
the design.  It is built and bound as :mod:`repro_torch.kernels.build` says.

:func:`flash_attention` is the wrapper, with the JAX kernel's signature and
layout.  On a CUDA tensor it launches the kernel or raises; on a CPU tensor
it computes the kernel's plain version
(:func:`repro_torch.kernels.ref.flash_attention_ref`).
``flash_attention.launches`` counts the kernel's launches, so a run can show
that it went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import CudaLibrary

HEAD_DIMS = (64, 128)
DTYPES = (torch.float32, torch.bfloat16)


def _bind(lib: ctypes.CDLL) -> None:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.ff_flash_attention.argtypes = [vp, vp, vp, vp, i, i, i, i, i, i, i,
                                       i, ctypes.c_float, vp]
    lib.ff_flash_attention.restype = i
    lib.ff_attn_error_string.argtypes = [i]
    lib.ff_attn_error_string.restype = ctypes.c_char_p


LIBRARY = CudaLibrary("flash_attention.cu", "ff_flash_attention", _bind)


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

    A CUDA tensor launches the kernel: float32 or bfloat16, D in (64, 128),
    all three contiguous and of one dtype — anything else raises.  A CPU
    tensor gets the plain version."""
    if not q.is_cuda:
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       scale=scale)
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
    if b * h * max(sq, sk) * d >= 2**31 or sq > 64 * 65535:
        raise ValueError("flash_attention: sizes out of range")
    out = torch.empty_like(q)
    lib = load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.ff_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h,
            sq, sk, d, int(q.dtype == torch.bfloat16), int(causal),
            int(window is not None), 0 if window is None else int(window),
            d ** -0.5 if scale is None else float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention: launch failed: CUDA error {rc} "
                           f"({lib.ff_attn_error_string(rc).decode()})")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
