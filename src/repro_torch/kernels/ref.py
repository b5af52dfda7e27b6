"""Plain PyTorch oracles for the hand-written kernels.

These are the semantic ground truth: every kernel must match its oracle to
float tolerance across the shape sweep in tests/test_torch_kernels.py, and
``chip_smoke.py`` holds the CUDA kernel against it on the card.
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
