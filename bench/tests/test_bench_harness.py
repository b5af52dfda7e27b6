"""The harness is driven by data: cells, configurations, mixes and
per-layer metrics are found by name, and a new one of each is added by
adding files and entries only.  The result line and the spec keep to the
benchmark's contract."""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from bench import harness
from bench.tests.conftest import ROOT, small_config, small_mix

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_cells_name_existing_files(spec):
    names = {c["name"] for c in spec["configs"]}
    for c in spec["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert harness.config_of(spec, c["name"])["limits"]
    for cell in spec["workloads"]:
        assert cell["config"] in names
        mix = harness.mix_of(cell["traffic"])
        assert (harness.BENCH / "drivers" / f"{mix['driver']}.py").is_file()
    for m in spec["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))
        assert m["moves"] in {e["name"] for e in spec["end_to_end"]}


def test_names_and_units_use_the_allowed_characters(spec):
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in spec[group]:
            assert NAME.match(entry["name"]), entry["name"]
    for cell in spec["workloads"]:
        assert NAME.match(cell["config"]) and NAME.match(cell["traffic"])
        assert len(cell["why"]) <= 200 and "\n" not in cell["why"]
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for c in spec["configs"]:
        for key in c["reduced"]:
            assert NAME.match(key)
    all_names = [e["name"] for g in ("end_to_end", "per_layer")
                 for e in spec[g]]
    assert len(all_names) == len(set(all_names))


def test_every_cell_reports_setup_another_metric_and_a_layer(spec):
    """What ``BENCHMARK.json`` lists for a cell is what its driver
    measures: ``setup_s``, at least one more, and a per-layer metric."""
    for cell in spec["workloads"]:
        listed = {m["name"] for m in spec["end_to_end"]
                  if cell["name"] in m.get("workloads", [cell["name"]])}
        drv = harness.driver_class(harness.mix_of(cell["traffic"])["driver"])
        assert listed == {"setup_s", *drv.reports}, cell["name"]
        assert len(listed) >= 2
        assert harness.cell_metrics_layer(spec, cell["name"])
    for m in spec["per_layer"]:
        assert m["workloads"], m["name"]


def test_new_config_mix_and_metric_are_found_without_edits(tmp_path, spec):
    """A copy of the benchmark gains a configuration, a mix, a metric and
    a cell by new files and new entries alone; the harness finds them."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "bench", root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    new = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p.relative_to(root): p.read_bytes()
              for p in (root / "bench").rglob("*") if p.is_file()}
    cfg = small_config(spec, "ff-kdd99", n=3000, f=7, trees=2, depth=3)
    cfg["name"] = "ff-tiny"
    (root / "bench" / "configs" / "ff-tiny.json").write_text(json.dumps(cfg))
    (root / "bench" / "traffic" / "fit_once.json").write_text(json.dumps(
        {"driver": "fit_loop", "warmup_units": 0, "trace_units": 1}))
    (root / "bench" / "metrics" / "fits_in_window.py").write_text(
        "def read(ctx):\n    return ctx.counters.get('fits')\n")
    new["configs"].append({"name": "ff-tiny", "source": "https://example.org",
                           "file": "bench/configs/ff-tiny.json",
                           "reduced": ["n_rows"], "why": "test"})
    new["workloads"].append({"name": "ff-tiny.fit", "config": "ff-tiny",
                             "traffic": "fit_once", "chips": 1,
                             "why": "test"})
    new["per_layer"].append({"name": "fits_in_window", "unit": "fits",
                             "better": "higher", "source": "program_counter",
                             "layer": "whole fit", "moves": "fit_s",
                             "workloads": ["ff-tiny.fit"]})
    (root / "BENCHMARK.json").write_text(json.dumps(new))
    code = (
        "import sys, json, time\n"
        f"sys.path[:0] = [{str(root)!r}, {str(ROOT / 'src')!r}]\n"
        "from pathlib import Path\n"
        "from bench import harness\n"
        f"spec = harness.load_spec(Path({str(root)!r}))\n"
        "for trace in (False, True):\n"
        "    r = harness.run_cell(spec, 'ff-tiny.fit', 5, 0.2, trace,\n"
        "                         t_start=time.perf_counter(), device='cpu')\n"
        "    print(json.dumps(r))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    plain, traced = (json.loads(line)
                     for line in out.stdout.strip().splitlines()[-2:])
    assert plain["correct"] is True and traced["correct"] is True
    assert set(plain["metrics"]) == {"setup_s", "fit_s"}
    assert traced["metrics"]["fits_in_window"]["value"] >= 1
    after = {p.relative_to(root): p.read_bytes()
             for p in (root / "bench").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    for path, data in before.items():
        assert after[path] == data, f"{path} was edited"


@pytest.mark.parametrize("trace", [False, True])
def test_result_object_has_the_contract_keys(spec, trace):
    cfg = small_config(spec, "ff-year", n=3000, f=7, trees=2, depth=3)
    r = harness.run_cell(spec, "ff-year.fit", 123456789012, 0.2, trace,
                         t_start=time.perf_counter(), device="cpu",
                         config=cfg)
    want = RESULT_KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(r) == want
    json.loads(json.dumps(r))
    if trace:
        assert set(r["metrics"]) <= {m["name"] for m in spec["per_layer"]}
        assert {"busy_s", "window_s"} <= set(r["device"])
        for key in ("device_ops", "idle_gaps"):
            assert len(r["breakdown"][key]) <= 10
    else:
        assert set(r["metrics"]) == {"setup_s", "fit_s"}
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"}


def test_run_exits_without_a_result_where_there_is_no_card(tmp_path):
    """Here (no CUDA card) and in a checkout holding only the benchmark's
    own files, the command exits non-zero and prints nothing on stdout."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    only = tmp_path / "only"
    shutil.copytree(ROOT / "bench", only / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", only / "BENCHMARK.json")
    env = dict(os.environ, BENCH_RUN="x")
    for where in (ROOT, only):
        out = subprocess.run(
            [sys.executable, "bench/run.py", "--workload", "ff-year.fit",
             "--seed", "1", "--seconds", "1", "--trace", "0"],
            cwd=where, capture_output=True, text=True, timeout=120, env=env)
        assert out.returncode != 0
        assert out.stdout.strip() == ""
