"""Run one cell of the benchmark of the PyTorch/CUDA port on this machine.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It drives ``repro_torch`` (``src/``) on one
NVIDIA card, never JAX or the JAX package, and prints as the last line of
standard output one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each number the comparison with the reference read, beside its
limit (also the last lines of standard error).

It exits 2 without a result where no CUDA card (or too few) is present or
the checkout lacks the program, and 3 where a JAX module is loaded once
the window has closed.  Build and kernel caches live under ``build/`` in
the checkout.  The process keeps to its first four cores.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _caches() -> None:
    """Every build and kernel cache at a fixed path in the checkout."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ["USE_FLAX"] = "0"


def _pin(n_cores: int = 4) -> None:
    """Hold this process (and every thread it starts) on the first few
    cores it may use, so that the host places it the same way each run."""
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) > n_cores:
        os.sched_setaffinity(0, cores[:n_cores])


def _fail(code: int, msg: str) -> None:
    print(f"bench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    _caches()
    _pin()
    for p in (ROOT / "src", ROOT):
        sys.path.insert(0, str(p))
    if not (ROOT / "src" / "repro_torch").is_dir():
        _fail(2, "the checkout holds no src/repro_torch: nothing to measure")
    import torch
    from bench import harness
    spec = harness.load_spec(ROOT)
    cell = harness.find_cell(spec, args.workload)
    if not torch.cuda.is_available():
        _fail(2, "no CUDA device is available")
    if torch.cuda.device_count() < int(cell["chips"]):
        _fail(2, f"{cell['chips']} cards asked, "
                 f"{torch.cuda.device_count()} present")
    torch.cuda.set_device(0)
    result = harness.run_cell(spec, args.workload, args.seed, args.seconds,
                              bool(args.trace), t_start=T_START,
                              device="cuda:0")
    bad = harness.forbidden_modules()
    if bad:
        _fail(3, f"JAX modules loaded in the measured process: {bad}")
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
