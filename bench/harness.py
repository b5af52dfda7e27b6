"""The benchmark's harness: one run of one cell, driven by data.

Everything that belongs to one piece sits in a file of its own, found by
its name in ``BENCHMARK.json``:

* ``configs/<config>.json``: the deployment (sizes, forest, party split,
  precision, the limits of the comparison that decides ``correct``);
* ``traffic/<traffic>.json``: the mix's parameters and the ``driver``
  that runs mixes of its kind (``drivers/<driver>.py``);
* ``metrics/<metric>.py``: one per-layer metric each, a ``read(ctx)``
  that returns the number or None where it finds nothing to read.

A run reports the end-to-end metrics its driver measured, and the
per-layer metrics whose ``workloads`` name its cell.

A run: set-up (the table from the seed, ingest, warm-up of the cell's own
shapes), the measured window, with ``--trace 1`` a profiled sub-window
after it, the device's memory peak, the program's state freed, then the
reference's judgement.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")   # top-level names, whole


class Context:
    """What a run knows; drivers and metric readers read and fill it."""

    def __init__(self, spec: dict, cell: dict, config: dict, mix: dict,
                 seed: int, device):
        self.spec, self.cell, self.config, self.mix = spec, cell, config, mix
        # any whole number: NumPy's streams want it non-negative
        self.seed = int(seed) % 2 ** 63
        self.device = torch.device(device)
        self.spans: dict = {}       # host-clock seconds the harness took
        self.counters: dict = {}    # program counters, as deltas
        self.counts: dict = {}      # the reference's counts of the work
        self.e2e: dict = {}         # the end-to-end metrics
        self.profile: dict | None = None
        self.driver_kind = ""


def _note(msg: str) -> None:
    print(f"bench: {msg}", file=sys.stderr, flush=True)


def load_spec(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def find_cell(spec: dict, name: str) -> dict:
    for cell in spec["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_of(spec: dict, name: str) -> dict:
    for c in spec["configs"]:
        if c["name"] == name:
            return _json(BENCH.parent / c["file"])
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def mix_of(name: str) -> dict:
    return _json(BENCH / "traffic" / f"{name}.json")


def driver_class(kind: str):
    return importlib.import_module(f"bench.drivers.{kind}").Driver


def metric_reader(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics_e2e(spec: dict, reported: dict) -> list[dict]:
    """The end-to-end metrics a run reports: those of ``BENCHMARK.json``
    that its driver measured (``setup_s`` in every run)."""
    return [m for m in spec["end_to_end"] if m["name"] in reported]


def cell_metrics_layer(spec: dict, cell: str) -> list[dict]:
    """The per-layer metrics a cell reports: those listing it."""
    return [m for m in spec["per_layer"] if cell in m["workloads"]]


def correct(numbers: dict, limits: dict, failed: int) -> tuple[bool, dict]:
    """The comparison that decides ``correct``: every number the reference
    read at or under its limit, and no request failed.  Returns it with
    each number beside its limit."""
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    ok = failed == 0 and all(c["value"] <= c["limit"]
                             for c in checks.values())
    return bool(ok), checks


def forbidden_modules() -> list[str]:
    return sorted({n for n in sys.modules
                   if n.split(".")[0] in FORBIDDEN})


def device_info(device, peak: int) -> dict:
    dev = torch.device(device)
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": 1, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": int(peak)}


def run_cell(spec: dict, cell_name: str, seed: int, seconds: float,
             trace: bool, *, t_start: float, device="cuda",
             config: dict | None = None, mix: dict | None = None) -> dict:
    """One run; returns the result object (``checks`` last).  ``config``
    and ``mix`` replace the cell's files (the tests run small copies)."""
    cell = find_cell(spec, cell_name)
    config = config if config is not None else config_of(spec, cell["config"])
    mix = mix if mix is not None else mix_of(cell["traffic"])
    ctx = Context(spec, cell, config, mix, seed, device)
    drv = driver_class(mix["driver"])(ctx)
    ctx.driver_kind = drv.kind

    drv.setup()
    setup_s = time.perf_counter() - t_start
    _note(f"set-up {setup_s:.2f} s (ingest {ctx.spans['ingest_s']:.2f} s)")
    ctx.e2e = drv.window(seconds)
    ctx.e2e["setup_s"] = setup_s
    _note(f"window {ctx.spans['window_s']:.2f} s: {ctx.e2e}; units "
          f"{ctx.spans.get('unit_s')}")
    if trace:
        from bench import trace as tracing
        t0 = time.perf_counter()
        _, ctx.profile = tracing.profile(drv.traced_unit(), ctx.device)
        _note(f"traced {ctx.profile['window_s']:.2f} s, busy "
              f"{ctx.profile['busy_s']:.3f} s, reduced in "
              f"{time.perf_counter() - t0:.2f} s")
    peak = (torch.cuda.max_memory_allocated(ctx.device)
            if ctx.device.type == "cuda" else 0)
    attempted, failed = drv.attempted()
    drv.release()
    t0 = time.perf_counter()
    numbers = drv.judge()
    _note(f"reference {time.perf_counter() - t0:.2f} s")

    ok, checks = correct(numbers, config["limits"], failed)
    if trace:
        metrics = {}
        for m in cell_metrics_layer(spec, cell_name):
            v = metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": ctx.e2e[m["name"]], "unit": m["unit"]}
                   for m in cell_metrics_e2e(spec, ctx.e2e)}
    result = {"correct": ok, "attempted": int(attempted),
              "failed": int(failed), "metrics": metrics,
              "device": device_info(ctx.device, peak)}
    if trace:
        from bench import trace as tracing
        result["device"]["busy_s"] = ctx.profile["busy_s"]
        result["device"]["window_s"] = ctx.profile["window_s"]
        result["breakdown"] = tracing.breakdown(ctx.profile)
    result["checks"] = checks
    return result
