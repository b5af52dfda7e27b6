#!/usr/bin/env python3
"""An LM trained FSDP × tensor-parallel on four cards.

Run from the root of a checkout, on a host with four NVIDIA H100s
(``chip_smoke.py`` phases 18 and 19 train the sharded LM on one card
only):

    python3 tools/sharded_train.py [--arch ARCH] [--meshes 2x2,1x4,4x1]
        [--expert-data] [--micro-batch N] [--policies dots,attn_out]

The model is ``models/parallel.py::ShardedLM(..., mode="train")``: one
process a rank of a (data, model) NCCL mesh, a card a rank, each rank
holding its slices of the weights and of AdamW's moments
(``models/sharding.py::param_specs(mode="train")``, ``opt_specs``),
drawn leaf by leaf from the unsharded model's seed, and running the
port's ``make_train_step`` on its rows of the batch.  The default arch,
phi3.5-moe-42b-a6.6b, holds 1.30 B parameters a layer at full width;
training keeps 12 bytes a parameter (bf16 weights and gradients, float32
μ and ν): its default depth 8 (10.66 B) needs ~128 GB, more than one
card, ~32 GB a rank over four.  With ``--expert-data`` each mesh is also
run with the expert stacks split over "data" (``expert_data``): no FSDP
gather of an expert stack, each rank's experts over the whole batch.
glm4-9b (``--arch glm4-9b``, full depth: 9.40 B parameters) has 2 kv
heads: at model = 4 each is replicated on two ranks.  whisper-large-v3
(``--arch whisper-large-v3``, 32 encoder and 32 decoder layers) trains on
8 x 416 tokens beside its 8 x 1500 audio frames, qwen2-vl-2b (``--arch
qwen2-vl-2b``) on 8 x 2048 positions, the first 256 its patches; the stubs
are drawn from the seed (``data/lm.py::stubs``).  ``--expert-data`` is
refused for an arch without experts.  zamba2-7b (``--arch zamba2-7b``,
full depth: 81 layers, 5.74 B parameters, ~126 GB of weights, gradients
and AdamW's old and new moments, so no one card trains it) and
xlstm-350m (``--arch xlstm-350m``) hold each rank's heads of every
recurrent leaf; their check (a) runs one pattern unit (zamba2's 6 layers,
xlstm's 2).  A model with sLSTM layers (xlstm-350m) has no profiled step
in (b): its step loop over the 2048 positions makes a profile of millions
of events.

  (a) float32 at full width and 2 layers (a pattern unit where it is
      longer), a batch of 8 x 256 (8 x 512
      for qwen2-vl-2b, past its 256 patches): the
      unsharded step on card 0 (its gradients moved to the host, the model
      freed) against each run of the meshes among (2, 2) and (1, 4) —
      loss, CE and aux
      within rtol 1e-5, every leaf's gradient slice (every 97th element)
      within 1e-3 of the leaf's largest magnitude (``chip_smoke.py``
      phase 18's bounds);
  (b) bf16 at full width and the depth, remat "unit", lr 3e-4, 5 steps on
      one batch of 8 x 2048 (in microbatches of ``--micro-batch`` rows) on
      each mesh: the
      step seconds (the slowest rank's; the median of the steps between
      the first and the last, which runs under ``torch.profiler`` for each
      rank's device milliseconds by kind: NCCL all-gathers,
      reduce-scatters, all-reduces, and the rest), tokens/s,
      6·N_active·tokens/s over the four cards' bf16 peak (N_active the
      parameters a token meets: the top_k of the experts; an encoder's
      parameters meet the frames instead of the tokens), peak GiB a
      rank, collective rounds and bytes a rank a step, CE by step (it
      falls on the fixed batch);
  (c) at (2, 2), two steps each under remat ``--policies`` ("dots" and
      "attn_out"; none with an empty list): the second's seconds and peak
      GiB a rank.

The first line is the card's name and power limit; one line a check or
a measurement follows, and a last JSON line holds the numbers.  Exit 0
only if every check holds.  ``--device cpu`` rehearses the same flow on
gloo CPU ranks at the reduced size (4 q heads on 2 kv heads: replicated
at model = 4).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CHECK_MESHES = ((2, 2), (1, 4))             # (data, model)
DEPTH = {"phi3.5-moe-42b-a6.6b": 8}         # on the cards; else the config's
SEQ = {"whisper-large-v3": 416}             # on the cards; else 2048
BF16_OPS_PER_S = 989e12                     # H100 SXM bf16, dense
STRIDE = 97


def meshes_arg(text: str) -> list[tuple[int, int]]:
    """"2x2,4x1" -> [(2, 2), (4, 1)]: (data, model) shapes."""
    return [tuple(int(n) for n in part.split("x")) for part in
            text.split(",") if part]


def predict(args) -> int:
    """(b)'s step at full width and the depth on each mesh, counted on fake
    tensors by the dry run (``launch/cases.py``): a rank's peak GiB, the
    roofline's least time and its bound, rounds and bytes sent a rank."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs
    from repro_torch.launch import cases
    from repro_torch.launch.mesh import RankMesh
    full = configs.get(args.arch)
    full = full.with_(n_layers=DEPTH.get(args.arch, full.n_layers))
    shape = cases.InputShape("b", "train", SEQ.get(args.arch, 2048), 8)
    for d, m in args.meshes:
        for ed in (False, True) if args.expert_data else (False,):
            mesh = RankMesh(("data", "model"), (d, m), ("cuda",) * (d * m),
                            "nccl", abstract=True)
            rec = cases.Case(args.arch, shape, full, mesh, "train",
                             args.micro_batch, ed).analyze()
            ro = rec["roofline"]
            print(f"predicted ({d}, {m}){' expert_data' if ed else ''}: "
                  f"{full.name}, {full.n_layers} layers, 8 x {shape.seq}, "
                  f"micro_batch {args.micro_batch}: peak "
                  f"{ro['mem_per_dev_gib']:.2f} GiB a rank; least "
                  f"{ro['least_s']:.4f} s ({ro['bottleneck']}: compute "
                  f"{ro['t_compute_s']:.4f}, memory {ro['t_memory_s']:.4f}, "
                  f"collective {ro['t_collective_s']:.4f}); "
                  f"{rec['rounds']:g} rounds, {rec['bytes_sent'] / 1e9:.2f} "
                  f"GB sent a rank; peak in {next(iter(rec['peak_regions']))}",
                  flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (a card a rank) or cpu (a rehearsal on gloo "
                         "CPU ranks at the reduced size)")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--arch", default="phi3.5-moe-42b-a6.6b")
    ap.add_argument("--meshes", type=meshes_arg,
                    default=[(2, 2), (1, 4), (4, 1)],
                    help="(data, model) shapes, e.g. 2x2,4x1")
    ap.add_argument("--expert-data", action="store_true",
                    help="run each mesh again with the expert stacks split "
                         "over 'data' (an MoE arch)")
    ap.add_argument("--micro-batch", type=int, default=0,
                    help="rows a microbatch in (b) (0: one backward pass)")
    ap.add_argument("--policies", default="dots,attn_out",
                    help="remat policies of (c), at (2, 2); '' for none")
    ap.add_argument("--predict", action="store_true",
                    help="print the dry run's prediction of (b) on each "
                         "mesh (launch/cases.py; on the host, no card) and "
                         "exit")
    args = ap.parse_args(argv)
    if args.predict:
        return predict(args)
    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs
    from repro_torch.configs.base import reduced
    from repro_torch.data import lm
    from repro_torch.launch.mesh import make_lm_mesh
    from repro_torch.models import parallel, transformer
    from repro_torch.train.step import accumulate_grads

    if args.expert_data and not configs.get(args.arch).n_experts:
        print(f"sharded_train: {args.arch} has no experts to split over "
              f"'data' (--expert-data)", file=sys.stderr)
        return 2
    on_card = args.device == "cuda"
    if on_card:
        if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
            print("sharded_train: needs four CUDA devices", file=sys.stderr)
            return 2
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        print(card, flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        full = configs.get(args.arch)
        full = full.with_(n_layers=DEPTH.get(args.arch, full.n_layers))
        backend, devices, session = "nccl", None, "cuda:0"
        b, s, sa = 8, SEQ.get(args.arch, 2048), 256 + full.n_patches
    else:
        card = "cpu"
        full = reduced(configs.get(args.arch)).with_(dtype="bfloat16")
        backend, devices, session = "gloo", "cpu", "cpu"
        b, s, sa = 8, 64, 32
    layouts = (False, True) if args.expert_data else (False,)
    ok = True
    result: dict = {"card": card, "arch": args.arch,
                    "n_layers": full.n_layers,
                    "micro_batch": args.micro_batch}

    def check(cond: bool, what: str) -> None:
        nonlocal ok
        print(("ok    " if cond else "FAIL  ") + what, flush=True)
        ok &= bool(cond)

    def mesh_of(d, m):
        return make_lm_mesh(data=d, model=m, backend=backend,
                            devices=devices)

    # (a) float32, full width, 2 layers: the unsharded step, then each mesh
    cfg = full.with_(n_layers=max(2, len(full.pattern)),
                     enc_layers=min(full.enc_layers, 2), dtype="float32")
    rng = np.random.default_rng(3)
    toks = lm._markov_tokens(rng, cfg.vocab, (b, sa))
    stubs = {k: v.numpy() for k, v in lm.stubs(cfg, rng, b).items()}
    model = transformer.init_params(cfg, seed=0, device=session)
    names, grads, metrics = accumulate_grads(
        model, {"tokens": torch.as_tensor(toks, device=session),
                **{k: torch.as_tensor(v, device=session)
                   for k, v in stubs.items()}})
    want = {k: float(v) for k, v in metrics.items()}
    ref = {n: g.detach().cpu() for n, g in zip(names, grads)}
    scale = {n: float(g.abs().max()) for n, g in ref.items()}
    del model, grads
    if on_card:
        torch.cuda.empty_cache()
    result["check"] = {}
    for (d, m), ed in ((mesh, ed) for mesh in args.meshes
                       if mesh in CHECK_MESHES for ed in layouts):
        mesh = mesh_of(d, m)
        label = f"({d}, {m}){' expert_data' if ed else ''}"
        with parallel.ShardedLM(cfg, mesh, mode="train",
                                expert_data=ed) as slm:
            slm.train_init()
            st, per = slm.grads(toks, stride=STRIDE, extras=stubs)
        worst, where = 0.0, None
        for r in sorted(per):
            parts = parallel.rank_slices(cfg, mesh, r, expert_data=ed)
            for n, got in per[r]["grads"].items():
                w = ref[n][parts[n]].reshape(-1)[::STRIDE].numpy()
                err = float(np.abs(got - w).max()) / max(scale[n], 1e-30)
                if err > worst:
                    worst, where = err, n
        loss_err = max(abs(st[k] - want[k]) / max(abs(want[k]), 1e-30)
                       for k in ("loss", "ce", "aux"))
        result["check"][label] = {"loss": st["loss"],
                                        "want_loss": want["loss"],
                                        "loss_rel_err": loss_err,
                                        "grad_err": worst, "grad_leaf": where}
        check(loss_err <= 1e-5,
              f"(a) {label} float32, {cfg.n_layers} layers, {b} x {sa}: "
              f"loss {st['loss']:.7f} CE {st['ce']:.7f} aux "
              f"{st['aux']:.7f} vs "
              f"unsharded {want['loss']:.7f} / {want['ce']:.7f} / "
              f"{want['aux']:.7f} (rtol 1e-5)")
        check(worst <= 1e-3,
              f"(a) {label} every leaf's gradient slice (each {STRIDE}th "
              f"element) within {worst:.3g} of the leaf's largest magnitude "
              f"({where}; bound 1e-3)")
    del ref

    # (b) bf16, full width, the depth: 5 steps a run on one batch
    n_params = sum(p.numel() for p in
                   transformer.Transformer(full, "meta").parameters())
    experts = sum(p.numel() for n, p in
                  transformer.Transformer(full, "meta").named_parameters()
                  if n.rsplit(".", 1)[-1] in ("we_gate", "we_up", "we_down"))
    n_active = n_params - experts + (experts * full.top_k // full.n_experts
                                     if full.n_experts else 0)
    n_enc = sum(p.numel() for n, p in
                transformer.Transformer(full, "meta").named_parameters()
                if n.startswith("enc_blocks."))
    # the model's operations a step: 6 a parameter a token it meets
    work = 6 * ((n_active - n_enc) * b * s + n_enc * b * full.enc_frames)
    rng = np.random.default_rng(0)
    batch = lm._markov_tokens(rng, full.vocab, (b, s))
    batch_stubs = {k: v.numpy() for k, v in lm.stubs(full, rng, b).items()}
    print(f"(b) {full.name}, {full.n_layers} layers, {full.dtype}, remat "
          f"{full.remat}: {n_params / 1e9:.3f} B params, {n_active / 1e9:.3f} "
          f"B active a token; one batch of {b} x {s}, {args.steps} steps at "
          f"lr 3e-4", flush=True)
    result.update(params=n_params, active_params=n_active, runs={})

    def run(d, m, cfg, steps, label, profile=False, ed=False):
        mesh = mesh_of(d, m)
        t0 = time.perf_counter()
        with parallel.ShardedLM(cfg, mesh, mode="train",
                                expert_data=ed) as slm:
            up_s = time.perf_counter() - t0
            opt_bytes = slm.train_init(lr=3e-4,
                                       micro_batch=args.micro_batch)
            stats = [slm.train_step(batch, profile=profile and
                                    i == steps - 1, extras=batch_stubs)[0]
                     for i in range(steps)]
            built = slm.built
        secs = [x["step_s"] for x in stats]
        timed = secs[1:-1] if profile else secs[1:]
        step_s = statistics.median(timed)
        last = stats[-1]
        r = {"up_s": up_s, "step_s": secs, "median_step_s": step_s,
             "tok_s": b * s / step_s,
             "mfu": work / step_s / (BF16_OPS_PER_S * mesh.size),
             "peak_gib": [x / 2**30 for x in last["peak_bytes"]],
             "param_gib": [built[q]["param_bytes"] / 2**30
                           for q in sorted(built)],
             "opt_gib": [opt_bytes[q] / 2**30 for q in sorted(opt_bytes)],
             "rounds": last["rounds"],
             "bytes_sent": last["bytes_sent"],
             "bytes_received": last["bytes_received"],
             "gathered_peak_gib": [x / 2**30
                                   for x in last["gathered_peak_bytes"]],
             "gathered_leaves": last["gathered_leaves"][0],
             "ce": [x["ce"] for x in stats], "aux": [x["aux"] for x in stats],
             "flash_launches": last["flash_launches"],
             "device_ms": last.get("device_ms")}
        lay = " expert_data" if ed else ""
        print(f"({label}) ({d}, {m}){lay} {cfg.remat}: ranks up and built "
              f"in {up_s:.1f} s; step s {[round(x, 4) for x in secs]} (median "
              f"of {[round(x, 4) for x in timed]}: {step_s:.4f} s) = "
              f"{r['tok_s']:.0f} tokens/s; "
              f"6·N_active·tokens/s = {r['mfu']:.2%} of the {mesh.size} "
              f"cards' bf16 peak; peak GiB a rank "
              f"{[round(x, 2) for x in r['peak_gib']]} (weights "
              f"{[round(x, 2) for x in r['param_gib']]}, μ + ν "
              f"{[round(x, 2) for x in r['opt_gib']]}, gathered weights at "
              f"most {[round(x, 3) for x in r['gathered_peak_gib']]}); "
              f"collective rounds a rank a step {r['rounds']}, bytes sent "
              f"{r['bytes_sent']}, received {r['bytes_received']}; leaves "
              f"gathered (rank 0) {r['gathered_leaves']}; CE "
              + " ".join(f"{c:.4f}" for c in r["ce"]), flush=True)
        if r["device_ms"]:
            print(f"({label}) ({d}, {m}){lay} the last step under the "
                  f"profiler, "
                  f"device ms a rank by kind: "
                  + "; ".join(f"rank {q}: " + ", ".join(
                      f"{k} {v:.1f}" for k, v in ms.items())
                      for q, ms in enumerate(r["device_ms"])), flush=True)
        return r

    for (d, m), ed in ((mesh, ed) for mesh in args.meshes for ed in layouts):
        r = run(d, m, full, args.steps, "b",
                profile="slstm" not in full.pattern, ed=ed)
        lay = " expert_data" if ed else ""
        result["runs"][f"{d}x{m}{lay}"] = r
        check(all(np.isfinite(r["ce"])) and r["ce"][-1] < r["ce"][0],
              f"(b) ({d}, {m}){lay} CE finite and falling on the fixed batch")
        check(r["flash_launches"] == [0] * (d * m),
              f"(b) ({d}, {m}){lay} no flash launch in training")
        if ed:
            check(not {"we_gate", "we_up", "we_down"}
                  & set(r["gathered_leaves"]),
                  f"(b) ({d}, {m}){lay} no expert stack gathered over "
                  f"'data'")

    # (c) the remat policies at (2, 2), one step each
    for policy in filter(None, args.policies.split(",")):
        r = run(2, 2, full.with_(remat=policy), 2, "c")
        result["runs"][f"2x2 {policy}"] = r
        check(all(np.isfinite(r["ce"])),
              f"(c) (2, 2) remat {policy}: CE finite")
    print("sharded_train: " + ("every check holds" if ok else "FAILED"),
          flush=True)
    print(json.dumps(result), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
