"""Distributed federation smoke: party-per-process fit + serve + a fault.

Launches a real M-party localhost deployment (one OS process per party,
message-passing collectives over sockets — federation/distributed.py) on
the CUDA card (``--device cpu``: CPU workers), trains a small forest
through it, checks the result bit for bit against the simulated substrate,
serves a few waves, then kills one party mid-traffic and shows the
degraded-serving path answering from the trees whose split paths avoid the
dead party's features::

    PYTHONPATH=src python -m repro_torch.launch.distributed_demo
    PYTHONPATH=src python -m repro_torch.launch.distributed_demo --device cpu

Exit code 0 means: fit bit-identity held, serving worked, the injected
failure was detected, and degraded serving produced exact predictions from
the surviving trees.
"""
from __future__ import annotations

import argparse
import os
import time

# Arm the privacy egress guard before any port import: the demo runs the
# whole flow with raw-array sends blocked at the wire (spawned party
# workers inherit the env and enforce the same policy on their side).
os.environ.setdefault("REPRO_EGRESS_GUARD", "1")

import numpy as np


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parties", type=int, default=3)
    ap.add_argument("--trees", type=int, default=12)
    ap.add_argument("--depth", type=int, default=3)
    ap.add_argument("--rows", type=int, default=300)
    ap.add_argument("--features", type=int, default=9)
    ap.add_argument("--round-timeout", type=float, default=60.0)
    ap.add_argument("--device", default=None,
                    help="where the session and the party workers compute "
                         "(default: the CUDA card)")
    ap.add_argument("--trace-out", default=None, metavar="DIR",
                    help="enable tracing and write spans.jsonl + trace.json "
                         "(Chrome trace) for the whole fit/serve run")
    args = ap.parse_args()

    if args.trace_out:
        # before the Federation spawns workers, so they inherit the env
        os.environ["REPRO_TRACE"] = "1"
        from repro_torch.observability import TRACER
        TRACER.enable()

    from repro_torch import convert
    from repro_torch.core import ForestParams
    from repro_torch.core.tree import PartyTree
    from repro_torch.data import make_classification
    from repro_torch.federation import Federation
    from repro_torch.federation.distributed import surviving_trees
    from repro_torch.federation.transport import RetryPolicy
    from repro_torch.serving import ServeConfig

    # feature subsampling so some trees' split paths avoid some party
    # entirely — those are the trees degraded serving can answer from
    p = ForestParams(n_estimators=args.trees, max_depth=args.depth,
                     n_bins=16, max_features=0.34, seed=0)
    x, y = make_classification(args.rows, args.features, 2, seed=0)

    # reference: the same fit on the simulated substrate
    sim = Federation(parties=args.parties, n_bins=p.n_bins,
                     device=args.device)
    sim.ingest(x, y)
    ref = sim.fit(p)

    t0 = time.time()
    fed = Federation(parties=args.parties, substrate="distributed",
                     n_bins=p.n_bins, device=args.device,
                     round_timeout=args.round_timeout,
                     retry=RetryPolicy(attempts=3, base=0.05, seed=0))
    try:
        fed.ingest(x, y)
        model = fed.fit(p)
        a = convert.party_trees_to_numpy(ref.trees_)
        b = convert.party_trees_to_numpy(model.trees_)
        assert all(np.array_equal(a[f], b[f]) for f in a), \
            "distributed fit diverged from the simulated reference"
        print(f"fit: {args.trees} trees over {args.parties} party processes "
              f"on {fed.device} in {time.time() - t0:.1f}s — bit-identical "
              f"to simulation")
        health = fed.substrate.health()
        print("health: " + ", ".join(
            f"party {k}={v * 1e3:.1f}ms" if v is not None
            else f"party {k}=DOWN" for k, v in sorted(health.items())))

        server = fed.serve(model, ServeConfig(buckets=(64,),
                                              allow_degraded=True))
        xt = x[:50]
        want = np.asarray(sim.predict(ref, xt))
        got = server.serve(xt)
        assert np.array_equal(got, want), "served predictions diverged"
        print(f"serve: {len(xt)} rows, bit-identical to simulation")

        if args.trace_out:
            # pull worker spans now, while all parties are still alive —
            # the chaos kill below takes the victim's buffer with it
            fed.collect_telemetry()

        # ---- injected failure: kill the party whose features the most
        # trees avoid (those trees keep answering exactly)
        survivors = {pi: surviving_trees(model.trees_, [pi]).size
                     for pi in range(args.parties)}
        victim = max(survivors, key=survivors.get)
        if survivors[victim] == 0:
            raise SystemExit("every tree splits on every party — raise "
                             "--trees or lower max_features")
        fed.substrate.chaos(victim, "die")
        got = server.serve(xt)        # wave rides the degraded path
        stats = server.wave_stats[-1]
        assert stats.get("degraded"), "expected a degraded wave"
        assert victim in stats["dead_parties"], stats
        sel = surviving_trees(ref.trees_, [victim])
        idx = np.asarray(sel)
        deg_model = type(ref)(p, device=ref.device)
        deg_model.trees_ = PartyTree(*(f[:, idx] for f in ref.trees_))
        deg_model.partition_ = ref.partition_
        deg_model._decode = ref._decode
        want_deg = np.asarray(deg_model.predict(xt))
        assert np.array_equal(got, want_deg), \
            "degraded predictions diverged from the surviving-tree forest"
        print(f"fault: party {victim} killed -> degraded serving from "
              f"{stats['n_trees']}/{args.trees} surviving trees, exact")

        if args.trace_out:
            import json
            os.makedirs(args.trace_out, exist_ok=True)
            jsonl = os.path.join(args.trace_out, "spans.jsonl")
            chrome = os.path.join(args.trace_out, "trace.json")
            n = fed.export_trace(jsonl, chrome)
            with open(chrome) as f:
                doc = json.load(f)
            events = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
            procs = {s["proc"] for s in fed.trace_spans()}
            assert n > 0 and len(events) == n, (n, len(events))
            assert any(p.startswith("party") for p in procs), \
                f"no worker spans crossed the wire: {sorted(procs)}"
            print(f"trace: {n} spans from {len(procs)} processes -> "
                  f"{jsonl} + {chrome}")
        print("ALL OK")
    finally:
        fed.close()


if __name__ == "__main__":
    main()
