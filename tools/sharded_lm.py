#!/usr/bin/env python3
"""An LM served tensor- and expert-parallel on four cards.

Run from the root of a checkout, on a host with four NVIDIA H100s
(``chip_smoke.py`` phases 17 and 19 run the sharded LM on one card only):

    python3 tools/sharded_lm.py [--arch ARCH] [--meshes 1x4,2x2]
                                [--expert-data]

The model is ``models/parallel.py::ShardedLM``: one process a rank of a
(data, model) NCCL mesh, a card a rank, each rank holding its slices of
the weights (``models/sharding.py::param_specs(mode="serve")``), drawn
leaf by leaf from the unsharded model's seed.  The default arch,
phi3.5-moe-42b-a6.6b, is 41.87 B parameters at full width and depth in
bf16, 83.7 GB: no one card holds it (its 16 experts four a rank at model
= 4, eight at model = 2; with ``--expert-data`` each mesh is also run
with the expert stacks split over "data", ``expert_data``, eight a rank
at data = 2).  glm4-9b (``--arch glm4-9b``) has 2 kv heads: at model = 4
each is replicated on the two ranks whose q heads read it.
whisper-large-v3 (``--arch whisper-large-v3``: 32 encoder and 32 decoder
layers, 20 heads, 5 a rank at model = 4) takes its audio frames stub
(8 x 1500 x 1280) beside its prompts of 416 tokens; qwen2-vl-2b (``--arch
qwen2-vl-2b``: 12 q heads on 2 kv heads, replicated at model = 4) its 256
patches, the first 256 of its 2048 positions.  The stubs are drawn from
the seed (``data/lm.py::stubs``); ``--expert-data`` is refused for an
arch without experts.  zamba2-7b (``--arch zamba2-7b``: 81 layers, 68
Mamba2 and 13 uses of its one shared attention block, 112 SSM heads, 28 a
rank at model = 4) and xlstm-350m (``--arch xlstm-350m``: 24 layers,
mLSTM and sLSTM, 4 heads, one a rank at model = 4) hold each rank's heads
of every recurrent leaf (``models/parallel.py``); their check runs one
pattern unit (zamba2's 6 layers, xlstm's 2).

  (a) float32 at full width and 2 layers (a pattern unit where it is
      longer): the unsharded model on card 0
      against the (1, 4) and (2, 2) meshes — last-position logits of an
      8 x 512 prefill (8 x 416 for whisper, 2 encoder layers too) within
      2e-3 of their largest magnitude with argmax equal, and a decode step
      after prefill(S) within 2e-3 of the unsharded prefill(S + 1) (at a
      capacity of 8.0, which drops nothing: at 1.25 a decode step is
      routed under another capacity);
  (b) bf16 at full width and depth (32 layers) on (1, 4) and (2, 2): a warm
      serving wave, then one timed wave of 8 prompts of 2048 tokens (416
      for whisper) and 32 greedy tokens (``launch/serve.py::serve_batch``
      on every rank): prefill and decode tokens/s (whisper's frames/s
      too), each rank's peak device memory, collective rounds and bytes
      sent, its flash launches a prefill (one an attention: a layer, a
      use of zamba2's shared block, and whisper's cross-attention and
      encoder layers), every logit finite; then one more prefill's
      collective rounds a rank (at data = 1 a recurrent model's are 2 a
      layer, out_norm's statistic and out_proj's sum or the shared
      block's wo and wd, and 2 more, the lookup and the logits' gather:
      164 for zamba2-7b, 50 for xlstm-350m).

The first line is the card's name and power limit; one line a check
follows.  Exit 0 only if every check holds.  ``--device cpu`` rehearses
the same flow on gloo CPU ranks at the reduced size (4 q heads on 2 kv
heads: replicated at model = 4).
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PROMPT = {"whisper-large-v3": 416}      # on the cards; else 2048


def flash_launches(cfg) -> int:
    """The flash kernel's launches a prefill: one for each self-attention
    (the decoder's, a use of a shared block, the encoder's) and each
    cross-attention."""
    from repro_torch.models import transformer
    attn = sum(k in ("attn", "attn_shared")
               for k in transformer.layer_kinds(cfg))
    return attn * (2 if cfg.cross_attention else 1) + cfg.enc_layers


def recurrent(cfg) -> bool:
    return any(k in ("mamba2", "mlstm", "slstm") for k in cfg.pattern)


def meshes_arg(text: str) -> list[tuple[int, int]]:
    """"1x4,2x2" -> [(1, 4), (2, 2)]: (data, model) shapes."""
    return [tuple(int(n) for n in part.split("x")) for part in
            text.split(",") if part]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (a card a rank) or cpu (a rehearsal on gloo "
                         "CPU ranks at the reduced size)")
    ap.add_argument("--arch", default="phi3.5-moe-42b-a6.6b")
    ap.add_argument("--meshes", type=meshes_arg, default=[(1, 4), (2, 2)],
                    help="(data, model) shapes, e.g. 1x4,2x2")
    ap.add_argument("--expert-data", action="store_true",
                    help="run each mesh again with the expert stacks split "
                         "over 'data' (an MoE arch)")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs
    from repro_torch.configs.base import reduced
    from repro_torch.data import lm
    from repro_torch.launch.mesh import make_lm_mesh
    from repro_torch.models import parallel, transformer

    if args.expert_data and not configs.get(args.arch).n_experts:
        print(f"sharded_lm: {args.arch} has no experts to split over "
              f"'data' (--expert-data)", file=sys.stderr)
        return 2
    on_card = args.device == "cuda"
    if on_card:
        if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
            print("sharded_lm: needs four CUDA devices", file=sys.stderr)
            return 2
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0], flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        from repro_torch.kernels import attention, histogram
        from repro_torch.kernels.build import build_all
        build_all([histogram.LIBRARY, attention.LIBRARY])
        full = configs.get(args.arch)
        backend, devices, session = "nccl", None, "cuda:0"
        b, s, max_new, tiny = 8, PROMPT.get(args.arch, 2048), 32, False
    else:
        full = reduced(configs.get(args.arch)).with_(dtype="bfloat16")
        backend, devices, session = "gloo", "cpu", "cpu"
        b, s, max_new, tiny = 8, 64, 4, True
    runs = [(d, m, ed) for d, m in args.meshes
            for ed in ((False, True) if args.expert_data else (False,))]
    ok = True

    def check(cond: bool, what: str) -> None:
        nonlocal ok
        print(("ok    " if cond else "FAIL  ") + what, flush=True)
        ok &= bool(cond)

    def name(d, m, ed):
        return f"({d}, {m}){' expert_data' if ed else ''}"

    # (a) float32, full width, 2 layers: the unsharded model against each
    # mesh; the decode check at a capacity that drops nothing (E / top_k,
    # 8.0 for phi3.5-moe): at the config's 1.25 a decode step's 8 tokens
    # and a prefill's are routed under different capacities
    cfg = full.with_(n_layers=max(2, len(full.pattern)),
                     enc_layers=min(full.enc_layers, 2), dtype="float32")
    nodrop = (cfg.with_(moe_capacity=cfg.n_experts / cfg.top_k)
              if cfg.n_experts else cfg)
    sa = 64 if tiny else min(512, s)
    rng = np.random.default_rng(3)
    toks = lm._markov_tokens(rng, cfg.vocab, (b, sa + 1))
    stubs = {k: v.numpy() for k, v in lm.stubs(cfg, rng, b).items()}
    extras = {k: torch.as_tensor(v, device=session)
              for k, v in stubs.items()}
    model = transformer.init_params(cfg, seed=0, device=session)
    want = model.prefill(torch.as_tensor(toks[:, :sa], device=session),
                         extras=extras)[0].cpu().numpy()
    whole = transformer.Transformer(nodrop, session)
    whole.load_state_dict(model.state_dict())
    del model
    want_next = whole.prefill(torch.as_tensor(toks, device=session),
                              extras=extras)[0].cpu().numpy()
    del extras
    del whole
    if on_card:
        torch.cuda.empty_cache()
    scale = float(np.abs(want).max())
    for d, m, ed in runs:
        mesh = make_lm_mesh(data=d, model=m, backend=backend,
                            devices=devices)
        with parallel.ShardedLM(cfg, mesh, expert_data=ed) as slm:
            got, per = slm.prefill(toks[:, :sa], extras=stubs)
            slm.build(nodrop)
            slm.prefill(toks[:, :sa], cache_len=sa + 1, extras=stubs)
            got_next = slm.decode(toks[:, sa:], sa)
        err = float(np.abs(got - want).max())
        step = float(np.abs(got_next - want_next).max())
        check(err <= 2e-3 * scale,
              f"(a) {name(d, m, ed)} float32, {cfg.n_layers} layers, {b} x "
              f"{sa}: logits vs unsharded max |diff| {err:.3g} (largest "
              f"|logit| "
              f"{scale:.3g})")
        check(np.array_equal(got.argmax(-1), want.argmax(-1)),
              f"(a) {name(d, m, ed)} argmax equal to the unsharded model's")
        check(step <= 2e-3,
              f"(a) {name(d, m, ed)} prefill(S) + decode vs unsharded "
              f"prefill(S + 1): max |diff| {step:.3g}")
        check([per[r]["flash_launches"] for r in sorted(per)]
              == ([flash_launches(cfg)] * mesh.size if on_card else
                  [0] * mesh.size),
              f"(a) {name(d, m, ed)} flash launches a prefill a rank "
              f"{[per[r]['flash_launches'] for r in sorted(per)]}")

    # (b) bf16, full width and depth: a warm wave, then one timed wave
    for d, m, ed in runs:
        rng = np.random.default_rng(0)
        mesh = make_lm_mesh(data=d, model=m, backend=backend,
                            devices=devices)
        t0 = time.perf_counter()
        with parallel.ShardedLM(full, mesh, seed=0, expert_data=ed) as slm:
            up_s = time.perf_counter() - t0
            built = slm.built
            print(f"(b) {name(d, m, ed)} {full.name}, {full.n_layers} layers, "
                  f"{full.dtype}: ranks up and built in {up_s:.1f} s "
                  f"(start {slm.start_s:.1f} s); params a rank "
                  f"{[built[r]['params'] for r in sorted(built)]} "
                  f"({[round(built[r]['param_bytes'] / 2**30, 2) for r in sorted(built)]} "
                  f"GiB), build s "
                  f"{[round(built[r]['build_s'], 2) for r in sorted(built)]}",
                  flush=True)
            for wave in ("warm", "timed"):
                prompts = lm._markov_tokens(rng, full.vocab, (b, s))
                stubs = {k: v.numpy() for k, v in
                         lm.stubs(full, rng, b).items()}
                tokens, st = slm.serve(prompts, max_new, s + max_new,
                                       extras=stubs)
            per = slm.prefill(prompts, extras=stubs)[1]
            rounds = [per[r]["rounds"] for r in sorted(per)]
            peak = [round(x / 2**30, 2) for x in st["peak_bytes"]]
            frames = (f" ({b * full.enc_frames / st['prefill_s']:.0f} "
                      f"frames/s)" if full.enc_layers else "")
            print(f"(b) {name(d, m, ed)} timed wave {b} x {s} + {max_new}: "
                  f"prefill {st['prefill_s']:.4f} s = "
                  f"{b * s / st['prefill_s']:.0f} tok/s{frames}; decode "
                  f"{st['decode_s']:.4f} s = {st['decode_tok_s']:.1f} "
                  f"tok/s; peak memory a rank {peak} GiB; collective "
                  f"rounds a rank {st['rounds']}, bytes sent a rank "
                  f"{st['bytes_sent']}", flush=True)
        check(st["logits_finite"] and tokens.shape == (b, max_new)
              and 0 <= tokens.min() and tokens.max() < full.vocab,
              f"(b) {name(d, m, ed)} every logit finite, tokens {tokens.shape}")
        check(st["flash_launches"] == ([flash_launches(full)] * mesh.size
                                       if on_card else [0] * mesh.size),
              f"(b) {name(d, m, ed)} flash launches a prefill a rank "
              f"{st['flash_launches']}")
        expect = 2 * full.n_layers + 2
        print(f"(b) {name(d, m, ed)} collective rounds a prefill a rank "
              f"{rounds}" + (f" (2 a layer and 2: {expect})"
                             if recurrent(full) and d == 1 else ""),
              flush=True)
        if recurrent(full) and d == 1:
            check(rounds == [expect] * mesh.size,
                  f"(b) {name(d, m, ed)} rounds a prefill {rounds}, "
                  f"expected {expect}")
    print("sharded_lm: " + ("every check holds" if ok else "FAILED"),
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
