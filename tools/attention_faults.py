#!/usr/bin/env python3
"""Plants faults in a copy of the bf16 flash-attention kernel and shows
whether the checks of ``chip_smoke.py`` phase 6 catch them at the serving
path's prefill shape (causal, B 8, H 16, S 2048, D 128, bf16).

Run from the root of a checkout, on a host with an NVIDIA H100:

    python3 tools/attention_faults.py

Each fault is one change to a copy of ``csrc/flash_attention.cu``, written
and built under ``build/kernels/``; the checkout's sources are not touched.

  skip tile — the query tile with 16 key tiles (the longest rows) leaves
              out key tile 8;
  swap box  — key tile 8's values arrive with their two 64-column halves
              swapped.

For the kernel as it is and for each fault it prints one JSON line: the
largest error, the largest ratio of error to ``chip_smoke._bf16_bound``,
and whether that bound and the flat 3e-2 tolerance hold.  It exits 0 only
if the kernel meets both and every fault breaks the bound.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FAULTS = {
    "skip tile": (
        "      // online softmax over the quad that holds each row\n",
        "      if (n_tiles == 16 && i == 8)\n"
        "        for (int j = 0; j < BK / 2; ++j) sc[j] = -INFINITY;\n"
        "      // online softmax over the quad that holds each row\n"),
    "swap box": (
        "tma_load(s_v(s) + b * BK * ROW, &tv, v_full(s), 64 * b, k0, bh);",
        "tma_load(s_v(s) + b * BK * ROW, &tv, v_full(s),\n"
        "                   64 * (kt_lo + i == 8 ? BOXES - 1 - b : b), k0,"
        " bh);"),
}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("attention_faults: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke
    from repro_torch.kernels import attention as attn
    from repro_torch.kernels import build, ref

    source = attn.LIBRARY.source.read_text()
    libraries = {"none": attn.LIBRARY}
    for name, (old, new) in FAULTS.items():
        if source.count(old) != 1:
            raise AssertionError(f"{name}: the line to change is not in the "
                                 f"kernel source once")
        stem = "flash_attention_" + name.replace(" ", "_")
        path = build.BUILD_DIR / f"{stem}.cu"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(source.replace(old, new))
        libraries[name] = build.CudaLibrary(str(path), f"ff_{stem}",
                                            attn._bind, attn.LIBRARY.defines)
    build.build_all(list(libraries.values()))
    print(f"card: {chip_smoke._card()}", flush=True)

    dev = torch.device("cuda")
    b, h, s, d = 8, 16, 2048, 128
    g = torch.Generator(device=dev).manual_seed(s * 7 + s + d)  # as phase 6
    q, k, v = (torch.randn((b, h, s, d), generator=g, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    kw = {"causal": True, "window": None}
    want = ref.flash_attention_ref(q, k, v, **kw)
    bound = chip_smoke._bf16_bound(torch, ref, q, k, v, want, kw)
    rows = {}
    for name, lib in libraries.items():
        attn.LIBRARY = lib
        attn._SMEM_SET.clear()     # the attribute is each library's own
        got = attn.flash_attention(q, k, v, **kw).float()
        diff = (got - want.float()).abs()
        rows[name] = {"fault": name, "max_abs_err": float(diff.max()),
                      "err_over_bound": float((diff / bound).max()),
                      "within_bound": bool((diff <= bound).all()),
                      "within_3e-2": torch.allclose(got, want.float(),
                                                    rtol=3e-2, atol=3e-2)}
        print(json.dumps(rows[name]), flush=True)
    kernel = rows.pop("none")
    ok = (kernel["within_bound"] and kernel["within_3e-2"]
          and not any(r["within_bound"] for r in rows.values()))
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
