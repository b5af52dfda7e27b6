"""Serving CLI for the federated forest: batched one-round prediction.

One Federation session owns the whole lifecycle: ingest -> fit ->
(checkpoint round-trip) -> serve, on the CUDA card (``--device cpu`` runs
it on the CPU).  The server comes out of ``fed.serve`` pre-bound to the
session's substrate; traffic goes through the RequestQueue — the forest
counterpart of launch/serve.py's LM serving CLI.  Reports per-wave latency,
aggregate rows/s, party-sum payload bytes, and the compile count (which
must stop growing after warmup: the bucket/pad/compile-once contract — on
the card one captured CUDA graph per bucket).

Training data arrives either as a synthetic pre-aligned matrix (default) or
party-first: per-party CSV extracts (``--party-csv name=path``, repeated)
aligned on hashed IDs at ingest.  On the party-first path, traffic is also
party-first: each request round submits per-party blocks with shuffled rows
and party-local superset rows, re-aligned by the queue before dispatch.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.serve_forest --parties 4 --depth 8
  PYTHONPATH=src python -m repro_torch.launch.serve_forest --dense   # no LeafTable
  PYTHONPATH=src python -m repro_torch.launch.serve_forest --async-waves 4 \
      --autotune   # async wave ring + traffic-autotuned buckets
  PYTHONPATH=src python -m repro_torch.launch.serve_forest --ckpt-dir /tmp/ff \
      --save-ckpt   # round-trip through fed.save / fed.load first
  PYTHONPATH=src python -m repro_torch.launch.serve_forest \
      --party-csv bank=/data/bank.csv --party-csv ecom=/data/ecom.csv
  PYTHONPATH=src python -m repro_torch.launch.serve_forest --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.core import ForestParams
from repro_torch.core.partyblock import PartyBlock
from repro_torch.data import make_classification
from repro_torch.federation import Federation
from repro_torch.launch.train import parse_party_csvs
from repro_torch.serving import RequestQueue, ServeConfig


def party_request(part, x_rows: np.ndarray, ids: np.ndarray,
                  rng: np.random.Generator) -> list[PartyBlock]:
    """Shape dense rows into per-party request blocks the way real traffic
    arrives: each party's rows independently shuffled, plus a few rows only
    that party holds (dropped at alignment)."""
    blocks = []
    for i, name in enumerate(part.party_names):
        gid = part.feat_gid[i][part.feat_gid[i] >= 0]
        order = rng.permutation(len(ids))
        extra = rng.normal(size=(int(rng.integers(1, 4)), len(gid)))
        blocks.append(PartyBlock(
            name=name, x=np.concatenate([x_rows[order][:, gid], extra]),
            ids=np.concatenate([ids[order],
                                [f"{name}-x{j}" for j in range(len(extra))]])))
    return blocks


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parties", type=int, default=3)
    ap.add_argument("--trees", type=int, default=8)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--train-rows", type=int, default=2000)
    ap.add_argument("--features", type=int, default=24)
    ap.add_argument("--buckets", default="32,256,2048")
    ap.add_argument("--requests", type=int, default=12,
                    help="random requests per traffic round")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--dense", action="store_true",
                    help="disable leaf compaction (baseline mask)")
    ap.add_argument("--async-waves", type=int, default=1, metavar="K",
                    help="in-flight wave ring depth (1 = synchronous; >1 "
                         "overlaps host binning/padding with device "
                         "execution)")
    ap.add_argument("--autotune", action="store_true",
                    help="after the first traffic round, retune the bucket "
                         "set from the observed request-size distribution")
    ap.add_argument("--ckpt-dir", default=None,
                    help="restore the PartyTree stack from this checkpoint "
                         "directory instead of using the in-memory fit")
    ap.add_argument("--save-ckpt", action="store_true",
                    help="save the fitted forest to --ckpt-dir first")
    ap.add_argument("--party-csv", action="append", default=None,
                    metavar="NAME=PATH",
                    help="per-party CSV extract (repeat once per party): "
                         "party-first ingest + party-block request traffic")
    ap.add_argument("--id-column", default="id")
    ap.add_argument("--label-column", default="label")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    buckets = tuple(int(b) for b in args.buckets.split(","))

    p = ForestParams(n_estimators=args.trees, max_depth=args.depth,
                     n_bins=16, seed=0)
    fed: Federation
    if args.party_csv:
        sources = parse_party_csvs(args.party_csv, args.id_column,
                                   args.label_column)
        fed = Federation(parties=len(sources), n_bins=p.n_bins,
                         device=args.device)
        part = fed.ingest(sources)
        x = part.dense_raw()
        print(f"aligned {part.n_samples} common samples across "
              f"{part.n_parties} parties {list(part.party_names)}")
    else:
        x, y = make_classification(args.train_rows, args.features, 2, seed=0)
        fed = Federation(parties=args.parties, n_bins=p.n_bins,
                         device=args.device)
        part = fed.ingest(x, y)
    t0 = time.time()
    model = fed.fit(p)
    print(f"fit: {args.trees} trees x depth {args.depth} over "
          f"{part.n_parties} parties in {time.time() - t0:.1f}s")

    if args.ckpt_dir and args.save_ckpt:
        fed.save(model, args.ckpt_dir, step=args.trees)
    if args.ckpt_dir:
        model = fed.load(args.ckpt_dir, p)
        print(f"restored PartyTree stack from {args.ckpt_dir}")

    server = fed.serve(model, ServeConfig(buckets=buckets,
                                          compact=not args.dense,
                                          max_inflight=args.async_waves))
    if server.leaf_table is not None:
        from repro_torch.serving.plan import compaction_ratio
        print(f"leaf table: {server.leaf_table.capacity} slots vs "
              f"{p.n_nodes} heap nodes "
              f"({compaction_ratio(server.leaf_table, p):.1f}x compaction)")

    t0 = time.time()
    server.warmup()
    print(f"warmup: compiled {server.compile_count} bucket programs "
          f"{buckets} on {server.device} in {time.time() - t0:.1f}s")

    rng = np.random.default_rng(1)
    queue = RequestQueue(server)
    for rnd in range(args.rounds):
        sizes = rng.integers(1, buckets[-1] // 2, size=args.requests)
        for k, s in enumerate(sizes):
            rows = x[rng.integers(0, len(x), size=s)]
            if args.party_csv:      # party-first traffic: per-party blocks,
                queue.submit_parties(party_request(   # re-aligned in-queue
                    part, rows, np.array([f"r{rnd}-{k}-{j}"
                                          for j in range(s)]), rng))
            else:
                queue.submit(rows)
        t0 = time.time()
        results = queue.drain()
        dt = time.time() - t0
        rows = int(sizes.sum())
        print(f"round {rnd}: {len(results)} requests / {rows} rows in "
              f"{dt:.3f}s ({rows / max(dt, 1e-9):.0f} rows/s, "
              f"inflight<={server.max_inflight})")
        if args.autotune and rnd == 0:
            server = fed.serve(model, ServeConfig(
                buckets=buckets, compact=not args.dense,
                max_inflight=args.async_waves, autotune_buckets=True),
                traffic=queue.request_stats)
            server.warmup()
            queue = RequestQueue(server)
            print(f"autotune: buckets {buckets} -> {server.buckets} "
                  f"(compiles now {server.compile_count})")
    s = server.stats_summary()
    if s["waves"]:
        print(f"summary: waves={s['waves']} p50={s['p50_ms']:.2f}ms "
              f"p95={s['p95_ms']:.2f}ms rows/s={s['rows_per_s']:.0f} "
              f"party_sum_bytes_total={s['comm_bytes_total']} "
              f"compiles={s['compile_count']}")
    else:   # --autotune --rounds 1: the retuned server saw no traffic yet
        print(f"summary: no waves served since the bucket retune "
              f"(compiles={server.compile_count})")
    # the compile-once contract, per autotune epoch: compile_count must not
    # have grown past the last warmup's bucket set
    if server.compile_count != len(server.buckets):
        raise AssertionError("recompiled after warmup!")


if __name__ == "__main__":
    main()
