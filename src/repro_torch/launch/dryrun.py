"""Multi-node dry run on the host: the port's counterpart of the JAX
package's ``launch/dryrun.py``.

For every (architecture × input shape) one rank's production step runs on
fake tensors (``launch/cases.py``) against the single-pod (16 × 16) and
multi-pod (2 × 16 × 16 = 512 GPUs) meshes of ``launch/mesh.py``, and
answers without a card: does a rank hold it (its peak live bytes against
80 GiB), how many FLOPs, HBM bytes and collective bytes does each rank
move, and which of the three bounds the step (``roofline.py``).  The three
terms are bounds from counts against NVIDIA's published H100 peaks, not
timings.

Results land in ``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``:
``status`` ok / skip / fail, ``memory`` (the peak a rank holds and whether
it fits), ``roofline`` (the three terms, the bottleneck, the least time,
model FLOPs over counted FLOPs), ``collectives`` (rounds and bytes by
kind).  A rank whose peak passes 80 GiB is ``ok`` with ``fits: false``; a
failure names its exception.

    python -m repro_torch.launch.dryrun --arch all --mesh both
    repro-torch-dryrun --arch qwen3-32b --shape train_4k --mesh single
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import pathlib
import time
import traceback

from repro_torch import roofline as rl
from repro_torch.configs import registry
from repro_torch.launch import cases, mesh as mesh_mod

OUT_DIR = (pathlib.Path(__file__).resolve().parents[3] / "experiments"
           / "dryrun_torch")


def _mesh_tag(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


def run_case(arch: str, shape_name: str, multi_pod: bool,
             out_dir: pathlib.Path = OUT_DIR, force: bool = False) -> dict:
    """One (arch × shape × mesh) case's record, written to ``out_dir``
    (read back from there unless ``force``)."""
    mesh_tag = _mesh_tag(multi_pod)
    out_path = out_dir / f"{arch}__{shape_name}__{mesh_tag}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())

    record: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
                    "device": "H100 SXM 80GB (NVIDIA's published peaks)",
                    "fake_device": cases.FAKE_DEVICE}
    t0 = time.time()
    try:
        if arch == "federated-forest":
            mesh = mesh_mod.make_forest_mesh(multi_pod=multi_pod)
            rec = cases.forest_case(shape_name, mesh).analyze()
            record["hist_route"] = "cuda"
        else:
            mesh = mesh_mod.make_production_mesh(multi_pod=multi_pod)
            case = cases.input_specs(arch, shape_name, mesh)
            rec = case.analyze()
            record["mode"] = case.mode
            record["micro_batch"] = case.micro_batch
        record.update(rec)
        ro = rec["roofline"]
        record["memory"] = {"peak_bytes": ro["mem_per_dev_gib"] * 2**30,
                            "peak_gib": ro["mem_per_dev_gib"],
                            "capacity_gib": rl.HBM_CAPACITY / 2**30,
                            "fits": ro["fits"]}
        record["count_s"] = round(time.time() - t0, 1)
        record["status"] = "ok"
    except cases.Skip as e:
        record["status"] = "skip"
        record["reason"] = str(e)
    except Exception as e:  # a failure here is a layout or host-read fault
        record["status"] = "fail"
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-3000:]

    out_dir.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(record, indent=2, default=float))
    return record


def _job(args) -> dict:
    return run_case(*args)


def line(rec: dict) -> str:
    """One case's line of the report."""
    tag = (f"{rec['arch']} × {rec['shape']} × "
           f"{'2x16x16' if rec['mesh'] == 'pod2x16x16' else '16x16'}")
    if rec["status"] == "ok":
        ro = rec["roofline"]
        return (f"OK   {tag}: mem/dev={ro['mem_per_dev_gib']:.2f}GiB"
                f"{'' if ro['fits'] else ' (does not fit 80)'} "
                f"bottleneck={ro['bottleneck']} "
                f"t=({ro['t_compute_s']:.3e},{ro['t_memory_s']:.3e},"
                f"{ro['t_collective_s']:.3e})s [{rec.get('count_s')}s]")
    if rec["status"] == "skip":
        return f"SKIP {tag}: {rec['reason']}"
    return f"FAIL {tag}: {rec['error']}"


def table(records: list[dict]) -> str:
    """The records as a Markdown table, a row an (arch × shape) with both
    meshes in each cell (16 x 16 / 2 x 16 x 16): GiB a rank (✗ where it
    does not fit 80), the three terms in seconds, the bottleneck, and
    model FLOPs over counted FLOPs."""
    rows: dict = {}
    for r in records:
        rows.setdefault((r["arch"], r["shape"]), {})[r["mesh"]] = r
    cols = {
        "GiB a rank": lambda ro: (f"{ro['mem_per_dev_gib']:.2f}"
                                  + ("" if ro["fits"] else " ✗")),
        "compute s": lambda ro: f"{ro['t_compute_s']:.3g}",
        "memory s": lambda ro: f"{ro['t_memory_s']:.3g}",
        "collective s": lambda ro: f"{ro['t_collective_s']:.3g}",
        "bound": lambda ro: ro["bottleneck"],
        "model / counted FLOPs":
            lambda ro: f"{ro.get('useful_flop_frac', 0):.3g}"}
    out = ["| case | " + " | ".join(cols) + " |",
           "|---" * (len(cols) + 1) + "|"]
    for (arch, shape), recs in rows.items():
        cells = [" / ".join(fn(recs[m]["roofline"])
                            if recs.get(m, {}).get("status") == "ok"
                            else recs.get(m, {}).get("status", "-")
                            for m in ("pod16x16", "pod2x16x16"))
                 for fn in cols.values()]
        out.append(f"| {arch} × {shape} | " + " | ".join(cells) + " |")
    return "\n".join(out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="multi-node dry run (H100)")
    ap.add_argument("--arch", default="all",
                    help="arch id, 'federated-forest', or 'all'")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cases counted at once, each in its own process")
    ap.add_argument("--table", action="store_true",
                    help="print the records as a Markdown table")
    args = ap.parse_args(argv)

    archs = (list(registry.ARCH_IDS) + ["federated-forest"]
             if args.arch == "all" else [args.arch])
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    jobs = []
    for arch in archs:
        shape_names = (list(cases.FOREST_SHAPES)
                       if arch == "federated-forest" else list(cases.SHAPES))
        if args.shape != "all":
            shape_names = [args.shape]
        jobs += [(arch, shape, mp, OUT_DIR, args.force)
                 for shape in shape_names for mp in meshes]
    # the longest first (xLSTM's time loop, zamba2's depth), so that the
    # pool's last job is a short one
    slow = {"xlstm-350m": 0, "zamba2-7b": 1}
    jobs.sort(key=lambda j: (slow.get(j[0], 2), j[1] != "train_4k"))
    if args.jobs > 1:
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(args.jobs, maxtasksperchild=1) as pool:
            records = pool.map(_job, jobs, chunksize=1)
    else:
        records = [_job(j) for j in jobs]
    n_fail = 0
    for rec in records:
        n_fail += rec["status"] == "fail"
        print(line(rec))
    if args.table:
        print(table(sorted(records, key=lambda r: (r["arch"], r["shape"]))))
    if n_fail:
        raise SystemExit(f"{n_fail} dry-run case(s) failed")


if __name__ == "__main__":
    main()
