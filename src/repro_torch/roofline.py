"""Roofline terms of one rank's step on an H100 cluster, from counts.

The port's counterpart of the JAX package's ``roofline.py``.  Three terms
per (arch × shape × mesh), in seconds, each a bound on a rank's step time:

    compute    = Σ FLOPs of each type / that type's peak rate
    memory     = bytes read and written / the HBM rate
    collective = Σ each collective's bytes / the slowest link its group
                 crosses

All three come from one rank's own step (``op_analysis.py`` counts it:
eager ops are unfused, so their bytes are the traffic the card moves;
``launch/cases.py`` runs the step on fake tensors), so no division by the
rank count follows.  They are counts held against NVIDIA's published peaks,
not timings: the step cannot run faster than the largest of them
(:attr:`Roofline.least_s`), and a measured time over it is the share a run
reaches.

Hardware constants (NVIDIA H100 SXM5 80GB, 700 W; one place for the whole
port — ``chip_smoke.py`` reads them here):

  * 989 TFLOP/s bf16 dense on the tensor cores, 67 TFLOP/s float32 on the
    CUDA cores (the port runs float32 products without TF32) — NVIDIA H100
    Tensor Core GPU data sheet, SXM column;
  * 3.35 TB/s and 80 GB of HBM3 — the same data sheet;
  * NVLink 4 inside a node of 8: 900 GB/s a GPU both ways together, so
    450 GB/s each way — the same data sheet;
  * between nodes, one 400 Gb/s ConnectX-7 port a GPU: 50 GB/s each way —
    NVIDIA DGX H100 user guide, hardware overview (8 single-port
    ConnectX-7 for the compute fabric).

A mesh's ranks sit on nodes of :data:`GPUS_PER_NODE` in rank order
(``launch/mesh.py``: ranks model-major), so a group of consecutive ranks
within one node talks over NVLink and any group that spans nodes over the
network.
"""
from __future__ import annotations

import dataclasses
from typing import Any

BF16_FLOPS = 989e12            # H100 SXM bf16 tensor cores, dense
F32_FLOPS = 67e12              # H100 SXM float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
HBM_CAPACITY = 80 * 2**30      # what a rank may hold, bytes (the 80 GiB bar)
NVLINK_BYTES_PER_S = 450e9     # NVLink 4, each way, inside a node
NETWORK_BYTES_PER_S = 50e9     # 400 Gb/s ConnectX-7 a GPU, each way
GPUS_PER_NODE = 8

# each dtype's peak rate of products (float32 and wider on the CUDA cores)
PEAK_FLOPS = {"bfloat16": BF16_FLOPS, "float16": BF16_FLOPS}


def peak_flops(dtype: str) -> float:
    """The peak product rate for inputs of ``dtype`` (a torch dtype's name
    without ``torch.``)."""
    return PEAK_FLOPS.get(dtype, F32_FLOPS)


def link_rate(ranks) -> float:
    """Bytes a second each way of the slowest link a group of ``ranks``
    crosses: NVLink inside one node, the network across nodes; 0 for a
    group of one (nothing moves)."""
    ranks = list(ranks)
    if len(ranks) < 2:
        return 0.0
    nodes = {r // GPUS_PER_NODE for r in ranks}
    return NVLINK_BYTES_PER_S if len(nodes) == 1 else NETWORK_BYTES_PER_S


@dataclasses.dataclass
class Roofline:
    """One rank's counts and the three terms they bound.

    ``flops_by_dtype`` maps an input dtype to the FLOPs of the products on
    it; ``coll_detail`` maps a collective kind to its rounds, bytes sent
    and received and bus bytes (``op_analysis.CollectiveTally``);
    ``coll_time`` is the sum of each collective's bus bytes over its
    group's link.  ``per_device_memory`` is the peak of live device bytes,
    the step's arguments included."""

    flops: float
    hbm_bytes: float
    coll_bytes: float
    coll_detail: dict[str, dict[str, float]]
    per_device_memory: float
    flops_by_dtype: dict[str, float] = dataclasses.field(default_factory=dict)
    coll_time: float = 0.0
    xla_flops: float = 0.0       # JAX's cost_analysis cross-check: none here
    unknown_trip_loops: int = 0  # every loop runs in Python: none uncounted

    @property
    def t_compute(self) -> float:
        if not self.flops_by_dtype:
            return self.flops / BF16_FLOPS
        return sum(f / peak_flops(dt) for dt, f in self.flops_by_dtype.items())

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BYTES_PER_S

    @property
    def t_collective(self) -> float:
        return self.coll_time

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def least_s(self) -> float:
        """The least time the step could take: the largest term."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def fits(self) -> bool:
        return self.per_device_memory <= HBM_CAPACITY

    def summary(self, model_flops_global: float = 0.0,
                n_chips: int = 1) -> dict[str, Any]:
        """The JAX package's summary keys (``hlo_*`` here: the counted
        ops'), with the least time and whether the peak fits one card."""
        d = {
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "least_s": self.least_s,
            "hlo_flops_per_dev": self.flops,
            "hlo_bytes_per_dev": self.hbm_bytes,
            "coll_bytes_per_dev": self.coll_bytes,
            "mem_per_dev_gib": self.per_device_memory / 2**30,
            "fits": self.fits,
            "flops_by_dtype": dict(self.flops_by_dtype),
            "xla_flops_per_dev": self.xla_flops,
            "unknown_trip_loops": self.unknown_trip_loops,
        }
        if model_flops_global:
            useful = model_flops_global / n_chips
            d["model_flops_per_dev"] = useful
            d["useful_flop_frac"] = useful / max(self.flops, 1.0)
        return d


def model_flops(cfg, kind: str, batch: int, seq: int) -> float:
    """MODEL_FLOPS: 6·N·D (train) or 2·N·D (inference), N = active params."""
    n = cfg.active_param_count()
    tokens = batch * seq if kind == "train" else (
        batch * seq if kind == "prefill" else batch * 1)
    mult = 6.0 if kind == "train" else 2.0
    return mult * n * tokens
