"""Named variants of a dry-run case and their roofline terms: the port's
counterpart of the JAX package's ``launch/perf.py``.

Each variant is an explicit, named experiment (its hypothesis in code), so
a log can cite exactly what changed.  The names are the JAX package's:

  qwen3-32b × train_4k        mb32 | probs_bf16 | remat_dots | combos
  qwen2-moe-a2.7b × prefill   moe_shard | moe_shard+probs_bf16
  federated-forest × ff_train    hist_sub | the histogram backends
  federated-forest × ff_predict  mask_u8 | argmax | compact

A variant that names a JAX histogram backend (``scatter``,
``segment_sum``, ``pallas_interpret``, ``ref``) maps to the port's route
for the same function on the card: the hand-written kernel (``"cuda"``;
the port's plain versions run on CPU tensors only, and a card's tensors
refuse them), and the record says which.  Every number is a count on fake
tensors held against H100 peaks (``roofline.py``), not a timing.

Records land in ``experiments/perf_torch/<arch>__<shape>__<variant>.json``.

    python -m repro_torch.launch.perf --case qwen3-32b:train_4k --variant mb32
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time

import torch

from repro_torch.launch import cases, mesh as mesh_mod

OUT_DIR = (pathlib.Path(__file__).resolve().parents[3] / "experiments"
           / "perf_torch")

# variant name -> (cfg overrides, extra kwargs): the JAX package's
NN_VARIANTS: dict[str, dict] = {
    "baseline":      dict(),
    "mb2":           dict(micro_batch=2),
    "mb4":           dict(micro_batch=4),
    "mb16":          dict(micro_batch=16),
    "mb32":          dict(micro_batch=32),
    "probs_bf16":    dict(overrides={"attn_probs_bf16": True}),
    "remat_dots":    dict(overrides={"remat": "dots"}),
    "remat_none":    dict(overrides={"remat": "none"}),
    "moe_shard":     dict(overrides={"moe_shard_acts": True}),
    "mb32+probs":    dict(micro_batch=32, overrides={"attn_probs_bf16": True}),
    "mb32+probs+dots": dict(micro_batch=32,
                            overrides={"attn_probs_bf16": True,
                                       "remat": "dots"}),
    "moe_shard+probs": dict(overrides={"moe_shard_acts": True,
                                       "attn_probs_bf16": True}),
    "scores_bf16":     dict(overrides={"attn_scores_bf16": True}),
    "remat_attn_out":  dict(overrides={"remat": "attn_out"}),
    "scores+attn_out": dict(overrides={"attn_scores_bf16": True,
                                       "remat": "attn_out"}),
    "moe_shard+scores": dict(overrides={"moe_shard_acts": True,
                                        "attn_scores_bf16": True}),
    "fsdp_layout":     dict(serve_layout=False),   # serving baseline layout
    "serve_layout":    dict(serve_layout=True),    # tensor-parallel weights
    "expert_data":     dict(expert_data=True),     # experts over data axis
    "pad_experts":     dict(overrides={"pad_experts": True}),  # E->64, model-EP
    "pad_experts+data": dict(overrides={"pad_experts": True}, expert_data=True),
}

# ff_train variant name -> (histogram backend, subtraction trick): the JAX
# package's names and backends; ROUTES maps each backend to the port's
FF_TRAIN_VARIANTS: dict[str, dict] = {
    "baseline":          dict(hist_impl="ref"),
    "hist_sub":          dict(hist_impl="ref", hist_subtraction=True),
    "scatter":           dict(hist_impl="scatter"),
    "segment_sum":       dict(hist_impl="segment_sum"),
    "pallas_interpret":  dict(hist_impl="pallas_interpret"),
    "hist_sub+scatter":  dict(hist_impl="scatter", hist_subtraction=True),
    "hist_sub+segment_sum": dict(hist_impl="segment_sum",
                                 hist_subtraction=True),
}

# a JAX histogram backend -> the port's route for the same function on a
# card's tensors: the kernel, whatever the JAX package computed it with
ROUTES = {"ref": "cuda", "scatter": "cuda", "segment_sum": "cuda",
          "pallas_interpret": "cuda", "pallas": "cuda"}

FF_PREDICT_VARIANTS = ("baseline", "mask_u8", "mask_u8+argmax",
                       "mask_u8+compact")


def _write(out: pathlib.Path, rec: dict) -> dict:
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rec, indent=2, default=float))
    return rec


def run_nn_variant(arch: str, shape: str, variant: str, force=False) -> dict:
    out = OUT_DIR / f"{arch}__{shape}__{variant}.json"
    if out.exists() and not force:
        return json.loads(out.read_text())
    kw = NN_VARIANTS[variant]
    mesh = mesh_mod.make_production_mesh()
    t0 = time.time()
    case = cases.input_specs(arch, shape, mesh,
                             overrides=kw.get("overrides"),
                             micro_batch=kw.get("micro_batch"),
                             serve_layout=kw.get("serve_layout"),
                             expert_data=kw.get("expert_data", False))
    rec = {"arch": arch, "shape": shape, "variant": variant,
           **case.analyze(), "wall_s": round(time.time() - t0, 1)}
    return _write(out, rec)


def run_ff_train_variant(variant: str, force=False) -> dict:
    """ff_train variants: the JAX package's histogram backends (each the
    kernel's route here) with and without histogram subtraction."""
    from repro_torch.core.types import ForestParams
    out = OUT_DIR / f"federated-forest__ff_train__{variant}.json"
    if out.exists() and not force:
        return json.loads(out.read_text())
    kw = FF_TRAIN_VARIANTS[variant]
    fs = cases.FOREST_SHAPES["ff_train"]
    p = ForestParams(task="classification", n_classes=2,
                     n_estimators=fs.n_trees_per_shard, max_depth=8,
                     n_bins=32,
                     hist_subtraction=kw.get("hist_subtraction", False))
    route = ROUTES[kw["hist_impl"]]
    t0 = time.time()
    rec = cases.forest_case("ff_train", mesh_mod.make_forest_mesh(
        multi_pod=False), params=p, hist_impl=route).analyze()
    rec = {"arch": "federated-forest", "shape": "ff_train",
           "variant": variant, "jax_hist_impl": kw["hist_impl"],
           "hist_route": route, **rec, "wall_s": round(time.time() - t0, 1)}
    return _write(out, rec)


def run_ff_variant(variant: str, force=False) -> dict:
    """federated-forest × ff_predict: int32 vs uint8 membership psum, the
    argmax vote, the leaf-compacted masks."""
    out = OUT_DIR / f"federated-forest__ff_predict__{variant}.json"
    if out.exists() and not force:
        return json.loads(out.read_text())
    if variant not in FF_PREDICT_VARIANTS:
        raise KeyError(variant)
    mask_dtype = torch.int32 if variant == "baseline" else torch.uint8
    vote_impl = "argmax" if variant.endswith("argmax") else "einsum"
    compact = variant.endswith("compact")
    t0 = time.time()
    rec = cases.forest_case("ff_predict", mesh_mod.make_forest_mesh(
        multi_pod=False), compact=compact, mask_dtype=mask_dtype,
        vote_impl=vote_impl).analyze()
    rec = {"arch": "federated-forest", "shape": "ff_predict",
           "variant": variant, **rec, "wall_s": round(time.time() - t0, 1)}
    return _write(out, rec)


def _report(rec: dict) -> None:
    ro = rec["roofline"]
    print(f"{rec['arch']} × {rec['shape']} × {rec['variant']}: "
          f"t=({ro['t_compute_s']:.3e}, {ro['t_memory_s']:.3e}, "
          f"{ro['t_collective_s']:.3e})s bound={ro['bottleneck']} "
          f"mem={ro['mem_per_dev_gib']:.2f}GiB"
          + (f" route={rec['hist_route']} (JAX: {rec['jax_hist_impl']})"
             if "hist_route" in rec else ""))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--case", required=True,
                    help="arch:shape (or federated-forest:ff_predict)")
    ap.add_argument("--variant", required=True)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    arch, shape = args.case.split(":")
    if arch == "federated-forest" and shape == "ff_train":
        rec = run_ff_train_variant(args.variant, force=args.force)
    elif arch == "federated-forest":
        rec = run_ff_variant(args.variant, force=args.force)
    else:
        rec = run_nn_variant(arch, shape, args.variant, force=args.force)
    _report(rec)


if __name__ == "__main__":
    main()
