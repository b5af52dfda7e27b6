#!/usr/bin/env python3
"""The sharded substrate over NCCL, one card a rank, against the simulated
substrate on the session's card.

Run from the root of a checkout, on a host with two or more NVIDIA H100s
(``chip_smoke.py`` phase 13 runs NCCL at one rank only on a one-card host):

    python3 tools/sharded_nccl.py

On phase 3's table (156,198 x 95, split 117,148 / 39,050; 20 trees, depth
8, 32 bins) it fits the forest on every NCCL mesh the host's cards allow —
(trees, parties) = (1, 2) with two cards, then (2, 2) and (1, 4) with four
— three times each, and serves the test rows through ``fed.serve``.  Each
mesh's PartyTree (all seven fields) and served answers must equal the
simulated substrate's FF(M) bit for bit.  It prints the card's name and
power limit, then one line a mesh: rank start seconds, the three fit
seconds (the first makes the NCCL communicators), the simulated fit beside
them (fitted twice, the second timed) and the served rows/s.  It exits 0
only if every mesh holds.
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

MESHES = ((1, 2), (2, 2), (1, 4))        # (trees, parties)


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("sharded_nccl: needs two or more CUDA devices", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import convert
    from repro_torch.core import ForestParams
    from repro_torch.data import make_classification, train_test_split
    from repro_torch.federation import Federation
    from repro_torch.kernels import histogram as hist
    from repro_torch.launch.mesh import make_forest_mesh
    from repro_torch.serving import ServeConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    hist.LIBRARY.load()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    cards = torch.cuda.device_count()
    x, y = make_classification(156198, 95, 2, n_informative=24, seed=0)
    xtr, ytr, xte, _ = train_test_split(x, y, 0.25, seed=1)
    params = ForestParams(n_estimators=20, max_depth=8, n_bins=32, seed=42)
    ok = True
    for trees, parties in MESHES:
        if trees * parties > cards:
            print(f"({trees}, {parties}): not run, {cards} cards")
            continue
        sim = Federation(parties=parties, n_bins=32)
        sim.ingest(xtr, ytr)
        sim.fit(params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = sim.fit(params)
        torch.cuda.synchronize()
        sim_s = time.perf_counter() - t0
        want = sim.predict(ref, xte)
        mesh = make_forest_mesh(trees=trees, parties=parties,
                                backend="nccl")
        with Federation(parties=parties, substrate="sharded", mesh=mesh,
                        n_bins=32) as fed:
            t0 = time.perf_counter()
            fed.substrate.coordinator            # spawn, join the world
            up_s = time.perf_counter() - t0
            fed.ingest(xtr, ytr)
            fits = []
            for _ in range(3):
                t0 = time.perf_counter()
                model = fed.fit(params)
                fits.append(time.perf_counter() - t0)
            got, exp = (convert.party_trees_to_numpy(m.trees_)
                        for m in (model, ref))
            bad = [f for f in exp if not np.array_equal(got[f], exp[f])]
            server = fed.serve(model, ServeConfig())
            server.serve(xte)
            t0 = time.perf_counter()
            served = server.serve(xte)
            serve_s = time.perf_counter() - t0
            same = not bad and np.array_equal(served, want)
            ok &= same
            print(f"({trees}, {parties}) on {list(mesh.devices)}: up "
                  f"{up_s:.3f} s; fits " + " / ".join(f"{f:.4f}" for f in fits)
                  + f" s (simulated FF({parties}) {sim_s:.4f} s); serve "
                  f"{len(xte)} rows {serve_s:.4f} s = "
                  f"{len(xte) / serve_s:.0f} rows/s; PartyTree and answers "
                  f"== simulated: {same}" + (f" (differs on {bad})"
                                             if bad else ""), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
