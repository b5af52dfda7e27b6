"""Federated forest inference serving engine, on the card.

Turns the paper's one-round prediction protocol (§4.2, Prop. 1) into a
servable system:

  * ``plan``   — LeafTable: per-tree live-leaf index tables.  A deep heap is
    mostly dead slots, so the membership mask, its single party sum, and
    the vote contraction are gathered over live leaves (bit-identical
    outputs — the intersection semantics do not change, only which columns
    are carried).
  * ``engine`` — bucket / pad / compile-once / async waves.  Traffic arrives
    in arbitrary batch sizes; the server pads each request up to a small set
    of row buckets (default 32/256/2048) and compiles one program per
    bucket — on the card, one captured CUDA graph per bucket, replayed for
    every wave — so steady-state serving never recompiles
    (``compile_count`` is the proof).  Waves dispatch asynchronously on the
    server's CUDA stream through a bounded in-flight ring of pinned host
    buffers (``max_inflight``): host binning/coalescing/padding of wave i+1
    overlaps device execution of wave i, bit-identically to the sync path.
    One ``ModelServer`` core serves every family — ``ForestServer`` (the
    paper's one-round protocol), ``BoostingServer``, ``LinearServer`` —
    behind ``Federation.serve``'s dispatch.
  * ``autotune`` — bucket sets learned from observed traffic (wave /
    request row-count quantiles) instead of hardcoded guesses; the
    compile-once contract holds per autotune epoch.
  * ``queue``  — RequestQueue: continuous micro-batching.  Pending requests
    coalesce into waves across request boundaries (many small requests share
    one launch; a huge one spans several), pumped two-phase through the
    async ring.
  * ``fleet``  — ServingFleet: N replicated server cells behind one front
    door — consistent-hash routing, token-bucket admission, per-cell
    bulkheads with typed shedding, poison quarantine + dead-letter sink,
    and cell kill/health-fail → keyspace redistribution with zero lost
    accepted requests.  Cells drain on threads, each server on its own
    CUDA stream.
  * ``metrics``— per-cell wave stats rolled up into FleetMetrics (pooled
    percentiles, busy-interval throughput, shed/dead-letter/degraded
    counters) with alert thresholds and a periodic snapshot hook.

Entry points: ``Federation.serve`` / ``Federation.serve_fleet`` (the session
API — pre-binds the substrate and keeps servers fresh across model
updates) and ``launch/serve_forest.py`` + ``launch/fleet_demo.py`` (CLI
traffic CLIs).
"""
from repro_torch.serving.autotune import (autotune_buckets,  # noqa: F401
                                          observed_row_counts)
from repro_torch.serving.config import ServeConfig  # noqa: F401
from repro_torch.serving.engine import (BoostingServer,  # noqa: F401
                                        ForestServer, InFlightWave,
                                        LinearServer, ModelServer,
                                        load_forest_trees, server_for)
from repro_torch.serving.fleet import (DeadLetter,  # noqa: F401
                                       FleetOverloadError, HashRing,
                                       ServingFleet, TokenBucket)
from repro_torch.serving.metrics import (AlertThresholds,  # noqa: F401
                                         CellStats, FleetMetrics, alerts)
from repro_torch.serving.plan import (LeafTable,  # noqa: F401
                                      build_leaf_table, compaction_ratio)
from repro_torch.serving.queue import (PoisonedWaveError,  # noqa: F401
                                       RequestQueue)
