"""Plain PyTorch oracles for the hand-written kernels.

These are the semantic ground truth: every kernel must match its oracle to
float tolerance across the shape sweeps in tests/test_torch_kernels.py and
tests/test_torch_attention.py, and ``chip_smoke.py`` holds each CUDA kernel
against its oracle on the card.
"""
from __future__ import annotations

import torch


def histogram_ref(xb: torch.Tensor, seg: torch.Tensor, stats: torch.Tensor,
                  n_level: int, n_bins: int) -> torch.Tensor:
    """Split-statistics histogram — the Federated Forest compute hot spot.

    hist[l, f, b, c] = sum_s 1[seg[s] == l] * 1[xb[s, f] == b] * stats[s, c]

    Args:
      xb:    (N, F) integer bin ids.
      seg:   (N,) node slot within the current tree level; -1 drops the sample.
      stats: (N, C) per-sample (already weight-multiplied) label statistics.
    Returns:
      (n_level, F, n_bins, C) float32.

    Two einsums: the node one-hot times the stats first, then one
    contraction over the samples (a matrix product, run in full float32).
    """
    dev = xb.device
    node1h = (seg.long()[:, None]
              == torch.arange(n_level, device=dev)[None, :]).to(torch.float32)
    bin1h = (xb.long()[:, :, None]
             == torch.arange(n_bins, device=dev)[None, None, :]
             ).to(torch.float32)
    z = torch.einsum("sl,sc->slc", node1h, stats.to(torch.float32))
    return torch.einsum("sfb,slc->lfbc", bin1h, z)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int | None = None,
                        scale: float | None = None) -> torch.Tensor:
    """Reference attention.  q: (B, H, Sq, D); k, v: (B, H, Sk, D), the GQA
    head repeat done by the caller.

    The last query row is aligned with the last key row
    (qpos = i + Sk - Sq).  Scores, softmax and the value sum run in full
    float32; the output has q's dtype.  A row with no visible key is 0."""
    f32 = torch.float32
    sq, sk = q.shape[2], k.shape[2]
    if scale is None:
        scale = q.shape[-1] ** -0.5
    dev = q.device
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(f32), k.to(f32)) * scale
    qpos = torch.arange(sq, device=dev)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=dev)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=dev)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.nan_to_num(
        torch.exp(logits - logits.amax(-1, keepdim=True)))
    probs = probs / probs.sum(-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v.to(f32)).to(q.dtype)
