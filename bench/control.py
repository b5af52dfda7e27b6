"""The control of the comparison that decides ``correct``: the reference
put in the program's place, computed one precision below the
configuration's (bfloat16 for float32), judged exactly as a run judges
the program.  It has to come out as not correct.

    python3 bench/control.py --workload <cell> --seeds 11,12,13 [--seconds 10]

For a fit cell the control grows the forest in bfloat16 and the
reference replays its trees (``split_regret``, ``stat_err``,
``bad_nodes``); for a serving cell the control forest answers the rows a
run of ``--seconds`` would check, against the reference forest's answers
(``answers_differ``).  The readings go through the harness's own
comparison (``harness.correct``); one JSON line a seed: ``correct``, which
has to read false, and each number beside its limit.  Runs on the card
where there is one; the benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(spec, cell_name: str, seed: int, seconds: float, device,
             dtype=None, config=None, mix=None) -> tuple[dict, dict]:
    """The control's numbers, as a run of the cell would compare them, and
    what they were read over."""
    import numpy as np
    import torch

    from bench import datagen, harness
    from bench.drivers import open_loop
    from bench.drivers.common import forest_of
    from bench.reference import forest as ref
    dtype = torch.bfloat16 if dtype is None else dtype
    cell = harness.find_cell(spec, cell_name)
    cfg = config if config is not None else harness.config_of(
        spec, cell["config"])
    mix = mix if mix is not None else harness.mix_of(cell["traffic"])
    serve = mix["driver"] == "open_loop"
    x, y, xt, _ = datagen.make_table(cfg, seed, device, test=serve)
    p = forest_of(cfg, seed)
    edges = ref.quantile_edges(x, p.n_bins)
    xb = ref.bin_rows(x, edges, device)
    control = ref.grow_forest(xb, y, p, dtype)
    if not serve:
        stats = ref.label_stats(y, p, device)
        n, f = xb.shape
        total = ref.Reading()
        for t, tree in enumerate(control):
            w, sel = ref.master_draws(p, n, f, t)
            total = total.merge(ref.replay_tree(tree, xb, stats, w, sel, p))
        return ({"split_regret": total.split_regret,
                 "stat_err": total.stat_err, "bad_nodes": total.bad_nodes},
                {"trees": len(control)})
    truth = ref.grow_forest(xb, y, p)
    due, starts, sizes = open_loop.schedule(mix, seconds, seed, len(xt))
    rng = np.random.default_rng([seed, 31])
    k = min(len(sizes), int(mix.get("check_requests", 2000)))
    pick = np.union1d(rng.choice(len(sizes), size=k, replace=False),
                      [int(np.argmax(sizes))])
    rows = np.concatenate([np.arange(starts[i], starts[i] + sizes[i])
                           for i in pick])
    xbt = ref.bin_rows(xt[rows], edges, device)
    diff = ref.predict(control, xbt, p) != ref.predict(truth, xbt, p)
    return {"answers_differ": int(diff.sum())}, {"rows": int(len(rows))}


def judged(spec, cell_name: str, seed: int, seconds: float, device,
           **kw) -> dict:
    """The control judged exactly as a run judges the program."""
    from bench import harness
    cfg = kw.get("config")
    if cfg is None:
        cfg = harness.config_of(spec,
                                harness.find_cell(spec, cell_name)["config"])
    numbers, info = readings(spec, cell_name, seed, seconds, device, **kw)
    ok, checks = harness.correct(numbers, cfg["limits"], 0)
    return {"correct": ok, "checks": checks, **info}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    for p in (ROOT / "src", ROOT):
        sys.path.insert(0, str(p))
    import torch

    from bench import harness
    spec = harness.load_spec(ROOT)
    device = "cuda:0" if torch.cuda.is_available() else "cpu"
    for s in args.seeds.split(","):
        r = judged(spec, args.workload, int(s), args.seconds, device)
        print(json.dumps({"workload": args.workload, "seed": int(s),
                          "device": device, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
