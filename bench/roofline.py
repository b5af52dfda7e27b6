"""The chip's published peaks and the work the forest's algorithm needs.

Peaks of one NVIDIA H100 SXM5 80GB at its 700 W limit (copied, with their
sources, from the port's ``roofline.py``; kept here so that the yardstick
does not move with the program):

* 3.35 TB/s of HBM3 and 80 GB — NVIDIA H100 Tensor Core GPU data sheet,
  SXM column;
* 67 TFLOP/s float32 outside the tensor cores, 989 TFLOP/s bf16 dense on
  the tensor cores — the same data sheet.

A forest fit does almost no arithmetic per byte (one add per sample,
feature and channel into a histogram cell), so its least time is its bytes
over the HBM rate.  The bytes are the algorithm's, counted from the trees'
shapes and not from what an implementation launches, so that fusing or
splitting kernels never moves the yardstick.  For each tree and each depth
d below the last, over the nodes the level searches (live, weighted count
at least ``min_samples_split``):

* histogram: each searched row's F bin bytes, its 4-byte node id and its
  C float32 stats read once; each searched node's F × B × C float32
  histogram written once;
* routing: each row of a node that splits reads its one bin byte of the
  split feature.

Rows of weight 0 (not drawn by the bootstrap) and rows resting at a leaf
are read by no level.  Node statistics follow from the parent's histogram,
so they cost no pass of their own.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
HBM_CAPACITY = 80e9            # bytes
F32_FLOPS = 67e12              # H100 SXM float32, CUDA cores
BF16_FLOPS = 989e12            # H100 SXM bf16 tensor cores, dense


def level_hist_bytes(search_rows: int, search_nodes: int, n_features: int,
                     n_bins: int, n_channels: int) -> int:
    """Bytes of one level's histogram: rows read, histograms written."""
    return (search_rows * (n_features + 4 + 4 * n_channels)
            + search_nodes * n_features * n_bins * n_channels * 4)


def level_route_bytes(split_rows: int) -> int:
    """Bytes of one level's routing: the split column's byte a row."""
    return split_rows


def tree_bytes(levels: list[dict], n_features: int, n_bins: int,
               n_channels: int) -> tuple[int, int]:
    """(histogram bytes, routing bytes) of one tree from its per-depth
    counts (``search_rows``, ``search_nodes``, ``split_rows``)."""
    hist = sum(level_hist_bytes(lv["search_rows"], lv["search_nodes"],
                                n_features, n_bins, n_channels)
               for lv in levels)
    route = sum(level_route_bytes(lv["split_rows"]) for lv in levels)
    return hist, route


def fit_bytes(trees: list[list[dict]], n_features: int, n_bins: int,
              n_channels: int) -> dict:
    """A fit's histogram, routing and total bytes over its trees."""
    hist = route = 0
    for levels in trees:
        h, r = tree_bytes(levels, n_features, n_bins, n_channels)
        hist += h
        route += r
    return {"hist_bytes": hist, "route_bytes": route,
            "bytes": hist + route}


def config_fit_bytes(trees: list[list[dict]], cfg: dict) -> dict:
    """:func:`fit_bytes` at a configuration's widths (its features, bins
    and label channels: a count a class, or three for regression)."""
    c = cfg["n_classes"] if cfg["task"] == "classification" else 3
    return fit_bytes(trees, cfg["n_features"], cfg["forest"]["n_bins"], c)


def least_seconds(n_bytes: float) -> float:
    """The least time of ``n_bytes`` of HBM traffic."""
    return n_bytes / HBM_BYTES_PER_S
