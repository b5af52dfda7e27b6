#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout, on a host with one NVIDIA H100:

    python3 chip_smoke.py

It drives the port's main path on the card, in phases; a failure in any
phase ends the run with a non-zero exit and no result line.

  1. build    — compile the CUDA histogram kernel from the checkout's source;
  2. kernel   — hold the kernel against its plain PyTorch version at the
                main path's shapes (integer stats bit-equal, float stats
                within rtol = atol = 1e-5, two launches bit-identical) and
                time it beside the plain version and ``index_add_``;
  3. main     — the paper's target-marketing table at full size (156,198
                customers x 95 features, two parties): ingest -> fit ->
                one-round predict through ``Federation``, with the kernel's
                launches counted, and the losslessness check FF(2) == FF(1);
                then one more fit and predict under ``torch.profiler``, for
                the device's busy time, idle share and kernels by time;
  4. frontier — regression at the superconduct size with depth 10, so the
                multi-pass frontier runs through the kernel; FF(2) == FF(1)
                bit for bit on the card;
  5. cpu      — at the quickstart's size, the classification forest fitted
                on the card equals the one fitted on the CPU, bit for bit;
                on a small regression fixture without near-ties, the same
                splits and leaf stats within rtol 1e-5.

The last lines are the card's name and power limit, a JSON object with the
kernel's numbers, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
L2_FLUSH_BYTES = 128 << 20     # more than the 50 MB L2 cache
SPLIT_FIELDS = ("is_leaf", "has_split", "split_floc", "split_bin", "owner",
                "split_gid")


def _phase(name: str):
    print(f"== phase {name}", flush=True)
    return time.perf_counter()


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def _time_ms(fn, torch, reps: int = 10, flush=None) -> float:
    """Mean device time of ``fn`` over ``reps`` launches, CUDA events around
    each, with the L2 cache flushed before each when ``flush`` is given."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        total += a.elapsed_time(b)
    return total / reps


def phase_kernel(torch, hist, ref, ops) -> list[dict]:
    """Kernel vs plain version at the main path's histogram shapes."""
    dev = torch.device("cuda")
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    shapes = [  # (what, N, F, B, L, C)
        ("classification root", 117148, 96, 32, 1, 2),
        ("classification depth 3", 117148, 96, 32, 8, 2),
        ("classification depth 7", 117148, 96, 32, 128, 2),
        ("regression frontier pass", 15947, 82, 64, 256, 3),
        # the node stats: one all-zero column, one bin (tree.py build_tree)
        ("node stats classification", 117148, 1, 1, 128, 2),
        ("node stats regression", 15947, 1, 1, 512, 3),
    ]
    rows = []
    for what, n, f, b, lv, c in shapes:
        g = torch.Generator(device=dev).manual_seed(n + f + lv)
        xb = torch.randint(0, b, (n, f), generator=g, device=dev,
                           dtype=torch.int32).to(torch.uint8)
        seg = torch.randint(-1, lv, (n,), generator=g, device=dev,
                            dtype=torch.int32)
        counts = torch.randint(0, 4, (n,), generator=g, device=dev)
        onehot = torch.nn.functional.one_hot(
            torch.randint(0, c, (n,), generator=g, device=dev), c)
        int_stats = (counts[:, None] * onehot).to(torch.float32).contiguous()
        # float stats are positive, as weights and weighted y^2 are: a cell
        # then sums without cancellation, its relative error is about
        # sqrt(n)*2^-24 in any order, and rtol = atol = 1e-5 is a real bound
        flt_stats = torch.rand((n, c), generator=g, device=dev)
        xc = hist.column_major(xb)

        got = hist.histogram_cuda(xc, seg, int_stats, lv, b)
        again = hist.histogram_cuda(xc, seg, int_stats, lv, b)
        want = ref.histogram_ref(xb, seg, int_stats, lv, b)
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: integer stats not bit-equal to "
                                 f"histogram_ref")
        if not torch.equal(got, again):
            raise AssertionError(f"{what}: two launches differ")
        got = hist.histogram_cuda(xc, seg, flt_stats, lv, b)
        again = hist.histogram_cuda(xc, seg, flt_stats, lv, b)
        want = ref.histogram_ref(xb, seg, flt_stats, lv, b)
        if not torch.allclose(got, want, rtol=1e-5, atol=1e-5):
            raise AssertionError(f"{what}: float stats beyond 1e-5")
        if not torch.equal(got, again):
            raise AssertionError(f"{what}: two launches differ (float)")
        err = float((got - want).abs().max())

        flat, vals = ops._flat_buckets(xb, seg, flt_stats, lv, b)
        lib_out = torch.zeros((lv * f * b + 1, c), device=dev)
        ms = _time_ms(lambda: hist.histogram_cuda(xc, seg, flt_stats, lv, b),
                      torch, flush=flush)
        plain_ms = _time_ms(lambda: ref.histogram_ref(xb, seg, flt_stats, lv, b),
                            torch, reps=3, flush=flush)
        library_ms = _time_ms(lambda: lib_out.index_add_(0, flat, vals),
                              torch, flush=flush)
        live = int((seg >= 0).sum())
        n_bytes = n * f + 4 * n + 4 * n * c + 4 * lv * f * b * c
        n_ops = live * f * c
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = n_ops / F32_OPS_PER_S * 1e3
        row = {"shape": f"N={n} F={f} B={b} L={lv} C={c}", "what": what,
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        print(json.dumps(row), flush=True)
        rows.append(row)
        del xb, xc, seg, int_stats, flt_stats, flat, vals, lib_out, got, want
        torch.cuda.empty_cache()
    return rows


def _profile(torch, fn):
    """``fn()`` once under ``torch.profiler``: returns its result and the
    host seconds (profiler overhead included), the device-busy seconds (the
    union of the kernels' intervals), the idle share and the kernels by
    device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in events):
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name: dict[str, list[float]] = {}
    for e in events:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    top = sorted(((sum(v) / 1e3, len(v), k) for k, v in by_name.items()),
                 reverse=True)[:6]
    busy_s = busy / 1e6
    if not events:
        raise AssertionError("the profiler recorded no device kernel")
    return out, {"host_s": host_s, "device_busy_s": busy_s,
                 "device_idle_share": max(0.0, 1.0 - busy_s / host_s),
                 "device_kernels": len(events),
                 "top": [{"name": k[:60], "ms": ms, "count": n}
                         for ms, n, k in top]}


def _fit_predict(Federation, parties, xtr, ytr, xte, params, torch,
                 device=None):
    """Ingest -> fit -> predict in a fresh session; the fit and predict
    seconds are host clock around work that ends in a device sync."""
    fed = Federation(parties=parties, n_bins=params.n_bins, device=device)
    fed.ingest(xtr, ytr)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = fed.fit(params)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    pred = fed.predict(model, xte)
    t2 = time.perf_counter()
    return fed, model, pred, t1 - t0, t2 - t1


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} is missing — run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np

    from repro_torch import convert
    from repro_torch.core import ForestParams
    from repro_torch.data import (accuracy, make_classification,
                                  make_regression, rmse, train_test_split)
    from repro_torch.federation import Federation
    from repro_torch.kernels import histogram as hist
    from repro_torch.kernels import ops, ref

    t0 = _phase("1 build")
    hist.load_library()
    build_s, log = hist.build_info()
    print(f"kernel build: {build_s:.2f} s (phase {time.perf_counter() - t0:.2f} s)")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())
    card = _card()
    print(f"card: {card}", flush=True)

    t0 = _phase("2 kernel vs plain")
    rows = phase_kernel(torch, hist, ref, ops)
    print(f"phase 2: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = _phase("3 main path: target marketing 156198 x 95, two parties")
    x, y = make_classification(156198, 95, 2, n_informative=24, seed=0)
    xtr, ytr, xte, yte = train_test_split(x, y, 0.25, seed=1)
    params = ForestParams(task="classification", n_estimators=20, max_depth=8,
                          n_bins=32, seed=42)
    hist.histogram_cuda.launches = 0
    fed, model, pred, fit_s, pred_s = _fit_predict(
        Federation, 2, xtr, ytr, xte, params, torch)
    launches = hist.histogram_cuda.launches
    acc = accuracy(yte, pred)
    print(f"train {len(ytr)} rows, test {len(yte)} rows; fit {fit_s:.3f} s, "
          f"predict {pred_s:.3f} s = {len(yte) / pred_s:.0f} rows/s, "
          f"accuracy {acc:.4f}, histogram launches {launches}", flush=True)
    if launches <= 0:
        raise AssertionError("the main path launched the histogram kernel "
                             "no time")
    if pred.shape != yte.shape or not 0.7 < acc <= 1.0:
        raise AssertionError(f"predictions look wrong: shape {pred.shape}, "
                             f"accuracy {acc}")
    if not np.array_equal(model.predict(xte), pred):
        raise AssertionError("dense prediction != leaf-compacted prediction")
    _, _, pred1, fit1_s, _ = _fit_predict(
        Federation, 1, xtr, ytr, xte, params, torch)
    if not np.array_equal(pred1, pred):
        raise AssertionError("losslessness violated: FF(1) != FF(2)")
    print(f"centralized (parties=1) fit {fit1_s:.3f} s; "
          f"centralized forest == federated forest: True")
    traced, prof = _profile(torch, lambda: fed.fit(params))
    print("traced fit:", json.dumps(prof))
    _, prof = _profile(torch, lambda: fed.predict(traced, xte))
    print("traced predict:", json.dumps(prof), flush=True)
    print(f"phase 3: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = _phase("4 regression frontier: superconduct 21263 x 81, depth 10")
    x, y = make_regression(21263, 81, seed=0)
    xtr, ytr, xte, yte = train_test_split(x, y, 0.25, seed=1)
    rparams = ForestParams(task="regression", n_estimators=10, max_depth=10,
                           n_bins=64, seed=0)
    hist.histogram_cuda.launches = 0
    _, rmodel2, rpred2, rfit2_s, _ = _fit_predict(
        Federation, 2, xtr, ytr, xte, rparams, torch)
    rlaunches = hist.histogram_cuda.launches
    _, rmodel1, rpred1, _, _ = _fit_predict(
        Federation, 1, xtr, ytr, xte, rparams, torch)
    t2 = convert.party_trees_to_numpy(rmodel2.trees_)
    t1 = convert.party_trees_to_numpy(rmodel1.trees_)
    for f in ("is_leaf", "leaf_stats", "split_gid"):
        if not np.array_equal(t2[f][0], t1[f][0]):
            raise AssertionError(f"regression FF(2) != FF(1) on {f}")
    if not np.array_equal(rpred2, rpred1) or not np.isfinite(rpred2).all():
        raise AssertionError("regression predictions: FF(2) != FF(1)")
    err = rmse(yte, rpred2)
    if not err < np.std(yte):
        raise AssertionError(f"regression rmse {err} is no better than the "
                             f"test targets' spread {np.std(yte)}")
    print(f"train {len(ytr)} rows; fit {rfit2_s:.3f} s, histogram launches "
          f"{rlaunches}, rmse {err:.4f} (targets' std {np.std(yte):.4f}); "
          f"FF(2) == FF(1) bit for bit: True", flush=True)
    print(f"phase 4: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = _phase("5 card vs cpu: quickstart 8000 x 95")
    x, y = make_classification(8000, 95, 2, n_informative=24, seed=0)
    xtr, ytr, xte, yte = train_test_split(x, y, 0.25, seed=1)
    _, gmodel, gpred, _, _ = _fit_predict(
        Federation, 2, xtr, ytr, xte, params, torch)
    _, cmodel, cpred, cfit_s, _ = _fit_predict(
        Federation, 2, xtr, ytr, xte, params, torch,
        device="cpu")
    g, c = (convert.party_trees_to_numpy(gmodel.trees_),
            convert.party_trees_to_numpy(cmodel.trees_))
    bad = [f for f in g if not np.array_equal(g[f], c[f])]
    if bad or not np.array_equal(gpred, cpred):
        raise AssertionError(f"card fit != cpu fit on {bad or 'predictions'}")
    print(f"cpu fit {cfit_s:.3f} s; PartyTree fitted on cuda == cpu, all "
          f"seven fields, and predictions equal: True")
    # regression: float sums associate differently on the card, so this
    # fixture is one whose trees meet no near-tie (tests/test_torch_tree.py)
    x, y = make_regression(1200, 13, seed=2)
    for cap in (0, 3):
        rp = ForestParams(task="regression", n_estimators=3, max_depth=5,
                          n_bins=16, seed=7, frontier_cap=cap)
        _, gmodel, gpred, _, _ = _fit_predict(
            Federation, 2, x, y, x[:300], rp, torch)
        _, cmodel, cpred, _, _ = _fit_predict(
            Federation, 2, x, y, x[:300], rp, torch, device="cpu")
        g, c = (convert.party_trees_to_numpy(gmodel.trees_),
                convert.party_trees_to_numpy(cmodel.trees_))
        bad = [f for f in SPLIT_FIELDS if not np.array_equal(g[f], c[f])]
        if bad:
            raise AssertionError(f"regression frontier_cap={cap}: card "
                                 f"splits != cpu splits on {bad}")
        if not (np.allclose(g["leaf_stats"], c["leaf_stats"], rtol=1e-5,
                            atol=0)
                and np.allclose(gpred, cpred, rtol=1e-5, atol=1e-6)):
            raise AssertionError(f"regression frontier_cap={cap}: leaf "
                                 f"stats or predictions beyond rtol 1e-5")
        lerr = float(np.max(np.abs(g["leaf_stats"] - c["leaf_stats"])))
        print(f"regression 1200 x 13, frontier_cap={cap}: card splits == "
              f"cpu splits: True; leaf stats max abs diff {lerr:.3g}")
    print(f"phase 5: {time.perf_counter() - t0:.1f} s", flush=True)

    main_row = next(r for r in rows if r["what"] == "classification depth 7")
    kernel = {"name": "histogram", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/histogram.cu",
              "replaces": "src/repro/kernels/histogram.py:70",
              "launches": launches,
              "max_abs_err": max(r["max_abs_err"] for r in rows),
              "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
              "bound_ms": main_row["bound_ms"],
              "bound_by": main_row["bound_by"],
              "library_ms": main_row["library_ms"],
              "shape": main_row["shape"]}
    print(card)
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:
        traceback.print_exc()
        code = 1
    sys.exit(code)
