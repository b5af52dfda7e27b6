"""Serving driver: batched prefill + greedy decode on the card.

Runs the serving path end to end: prefill a batch of prompts (attention
through the flash-attention kernel, filling the ring-buffer KV cache), then
decode ``max_new`` greedy tokens against that cache.  By default at the
reduced size of the JAX package's CLI; ``--device cpu`` runs it on the CPU.
The CLI's prompts are tokens only, as the JAX CLI's: an encoder-decoder
(whisper-large-v3) needs audio frames and raises there; ``serve_batch``
takes them as ``extras``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.configs.base import reduced
from repro_torch.models import transformer


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def serve_batch(cfg, model, prompts: np.ndarray, max_new: int,
                cache_len: int, extras: dict | None = None):
    """One serving wave: prefill the batch, decode max_new tokens.

    ``extras`` are the prompts' modality stubs (``frames`` for an
    encoder-decoder, ``patches`` for a VLM), tensors moved to the model's
    device; None is the JAX package's ``{}``.  Returns the (B, max_new)
    greedy tokens as a NumPy array and the wave's stats: prefill and decode
    seconds (host clock around work that ends in a device sync), decode
    tokens/s, and whether every logit was finite."""
    dev = model.device
    b, s = prompts.shape
    tokens = torch.as_tensor(prompts, dtype=torch.int64, device=dev)
    extras = {k: v.to(dev) for k, v in (extras or {}).items()}
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = model.prefill(tokens, cache_len=cache_len, extras=extras)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    finite = torch.isfinite(logits).all()
    tok = logits.argmax(-1)[:, None]
    out = [tok]
    t0 = time.perf_counter()
    for i in range(max_new - 1):
        logits, cache = model.decode_step(cache, tok, s + i)
        finite &= torch.isfinite(logits).all()
        tok = logits.argmax(-1)[:, None]
        out.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    return (torch.cat(out, 1).cpu().numpy(),
            {"prefill_s": t_prefill, "decode_s": t_decode,
             "decode_tok_s": b * (max_new - 1) / max(t_decode, 1e-9),
             "logits_finite": bool(finite)})


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = reduced(registry.get(args.arch))
    model = transformer.init_params(cfg, seed=0, device=args.device)
    rng = np.random.default_rng(0)
    for wave in range(2):
        prompts = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len))
        toks, stats = serve_batch(cfg, model, prompts, args.max_new,
                                  cache_len=args.prompt_len + args.max_new)
        print(f"wave {wave}: decoded {toks.shape}, "
              f"prefill {stats['prefill_s']:.2f}s, "
              f"decode {stats['decode_tok_s']:.1f} tok/s")


if __name__ == "__main__":
    main()
