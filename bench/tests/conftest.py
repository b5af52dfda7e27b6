"""Shared fixtures of the benchmark's tests: the spec and small copies of
its configurations, so that a whole run fits a test on the CPU."""
from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from bench import harness  # noqa: E402


@pytest.fixture(scope="session")
def spec():
    return harness.load_spec(ROOT)


# ``ff-kdd99.fit`` waits among PERF.md's open questions: its runs spread
# past any bound the benchmark can hold.  Its path, the integer route of
# the histogram, stays tested as the entry that would add it back.
KDD_FIT = {"name": "ff-kdd99.fit", "config": "ff-kdd99",
           "traffic": "fit_loop", "chips": 1,
           "why": "closed-loop fits on 3M x 41 rows, 20 trees depth 8"}


@pytest.fixture(scope="session")
def spec_plus(spec):
    """The spec with ``ff-kdd99.fit`` added as an entry, where it lacks it,
    reporting what ``ff-year.fit`` reports."""
    s = copy.deepcopy(spec)
    if all(c["name"] != KDD_FIT["name"] for c in s["workloads"]):
        s["workloads"].append(dict(KDD_FIT))
        for m in s["end_to_end"] + s["per_layer"]:
            if "ff-year.fit" in m.get("workloads", ()):
                m["workloads"].append(KDD_FIT["name"])
    return s


def small_config(spec, name: str, *, n: int = 6000, f: int = 11,
                 trees: int = 3, depth: int = 4, cap: int | None = None):
    c = copy.deepcopy(harness.config_of(spec, name))
    c.update(n_rows=n, n_features=f)
    c["forest"].update(n_estimators=trees, max_depth=depth)
    if cap is not None:
        c["forest"]["frontier_cap"] = cap
    return c


def small_mix(name: str, **over):
    m = dict(harness.mix_of(name))
    if m["driver"] == "open_loop":
        m.update(rate_per_s=150, buckets=[8, 64, 256], check_requests=60,
                 trace_seconds=0.3)
    m.update(over)
    return m


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda:0"
