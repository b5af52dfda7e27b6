"""Serving steps: prefill and single-token decode against a ring-buffer cache.

``serve_step`` is ONE new token with a KV cache of the context length.  The
model (a :class:`repro_torch.models.transformer.Transformer`) takes the
place of the JAX package's parameter pytree.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer


def make_prefill_step(cfg: ArchConfig):
    """``prefill_step(model, batch)``: the batch's keys other than
    ``tokens`` go to ``prefill`` as the extras (the modality stubs), as in
    the JAX package; a configuration ignores those it has no use for."""
    def prefill_step(model, batch):
        extras = {k: v for k, v in batch.items() if k != "tokens"}
        return model.prefill(batch["tokens"], extras=extras)
    return prefill_step


def make_serve_step(cfg: ArchConfig):
    def serve_step(model, cache, token, pos: int):
        return model.decode_step(cache, token, pos)
    return serve_step


def make_cache(cfg: ArchConfig, batch: int, seq_len: int, device=None):
    return transformer.make_cache(cfg, batch, seq_len, device)
