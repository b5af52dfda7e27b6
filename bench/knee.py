"""Find a serving cell's knee: the highest offered rate with no growing
backlog.  One set-up, then the cell's arrivals at each rate in turn.

    python3 bench/knee.py --workload ff-kdd99.serve --seed 7 --seconds 10 \
        --rates 1000,2000,4000

One JSON line a rate: offered requests/s, rows/s answered, latency
percentiles (ms, from when each request was due), the median latency of
the first and the last fifth of the requests (a backlog that grows shows
as the second far above the first) and the pump's largest lateness in
submitting.  The benchmark's own runs never run it; the rate it finds is
written into the mix's file as a number.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    for p in (ROOT / "src", ROOT):
        sys.path.insert(0, str(p))
    import numpy as np
    import torch

    from bench import harness
    spec = harness.load_spec(ROOT)
    cell = harness.find_cell(spec, args.workload)
    mix = harness.mix_of(cell["traffic"])
    ctx = harness.Context(spec, cell, harness.config_of(spec, cell["config"]),
                          mix, args.seed, "cuda:0")
    drv = harness.driver_class(mix["driver"])(ctx)
    t0 = time.perf_counter()
    drv.setup()
    print(json.dumps({"setup_s": time.perf_counter() - t0,
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    for rate in (float(r) for r in args.rates.split(",")):
        ctx.mix = dict(mix, rate_per_s=rate)
        ctx.spans.pop("submit_lag_s", None)
        due, starts, sizes, rids, done, _, _ = drv._serve(args.seconds,
                                                          args.seed)
        lat = np.array([done.get(r, np.inf) - d for r, d in zip(rids, due)])
        last = max(done.values())
        fifth = max(1, len(lat) // 5)
        p50, p95, p99 = np.percentile(lat, [50, 95, 99]) * 1e3
        print(json.dumps({
            "rate_per_s": rate, "requests": len(lat),
            "rows_per_s": float(sizes.sum() / last),
            "p50_ms": p50, "p95_ms": p95, "p99_ms": p99,
            "first_fifth_p50_ms": float(np.median(lat[:fifth]) * 1e3),
            "last_fifth_p50_ms": float(np.median(lat[-fifth:]) * 1e3),
            "submit_lag_ms": ctx.spans["submit_lag_s"] * 1e3,
            "drain_s": last - args.seconds}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
