"""Model assembly for the dense family: embed -> blocks -> norm -> lm_head.

The port of the dense part of the JAX package's ``models/transformer.py``.
The JAX package scans over stacked pattern units and then runs the
unscanned tail blocks; here :class:`Transformer` holds one block per layer
in a ``ModuleList`` (units in order, then the tail) and loops over them.

Entry points, matching the JAX package's:
  * :meth:`Transformer.prefill`     — logits for the last position and a
                                      populated ring-buffer KV cache;
  * :meth:`Transformer.decode_step` — ONE token against that cache;
  * :func:`make_cache`              — an empty cache for decode alone.
Training (``forward_train``, ``lm_loss``) is not ported yet.  MoE, SSM,
hybrid, encoder-decoder and VLM configurations raise NotImplementedError
(:func:`check_supported`).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers
from repro_torch.models.layers import AttnMode, attention, mlp, rmsnorm


def check_supported(cfg: ArchConfig) -> None:
    """Raise NotImplementedError for what the port's model does not run."""
    unsupported = [k for k in cfg.pattern if k != "attn"]
    why = []
    if cfg.n_experts:
        why.append(f"n_experts={cfg.n_experts} (MoE)")
    if unsupported:
        why.append(f"block kinds {sorted(set(unsupported))}")
    if cfg.enc_layers:
        why.append(f"enc_layers={cfg.enc_layers} (encoder-decoder)")
    if cfg.cross_attention:
        why.append("cross_attention")
    if cfg.n_patches:
        why.append(f"n_patches={cfg.n_patches} (VLM)")
    if why:
        raise NotImplementedError(
            f"{cfg.name}: the port runs dense attention models only; "
            f"not ported: {', '.join(why)}")


class Block(nn.Module):
    """One dense layer: ln1 -> attention -> residual, ln2 -> MLP ->
    residual.  ``ln1``/``ln2`` are float32 scales."""

    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        self.ln1 = layers.empty_param((cfg.d_model,), torch.float32, device)
        self.ln2 = layers.empty_param((cfg.d_model,), torch.float32, device)
        self.attn = layers.Attention(cfg, device)
        self.ffn = layers.MLP(cfg, device)

    def forward(self, x, cfg: ArchConfig, positions, *, cache=None, pos=None,
                cache_len=None):
        mode = AttnMode("causal", window=cfg.sliding_window)
        h = rmsnorm(x, self.ln1, cfg.norm_eps)
        out, new_cache = attention(self.attn, h, cfg, mode=mode,
                                   positions=positions, cache=cache, pos=pos,
                                   cache_len=cache_len)
        x = x + out
        h = rmsnorm(x, self.ln2, cfg.norm_eps)
        return x + mlp(self.ffn, h), new_cache


class Transformer(nn.Module):
    """A dense LM with uninitialised weights on ``device`` (``None``: the
    CUDA card).  Fill it with :func:`init_params` or
    :func:`repro_torch.convert.lm_params_from_numpy`.

    Weights follow the JAX package's layout and dtypes: ``embed`` (V, d)
    and ``lm_head`` (d, V) in ``cfg.dtype``, ``final_norm`` float32."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        check_supported(cfg)
        dev = resolve_device(device)
        dt = layers.torch_dtype(cfg)
        self.cfg = cfg
        self.embed = layers.empty_param((cfg.vocab, cfg.d_model), dt, dev)
        self.blocks = nn.ModuleList(Block(cfg, dev)
                                    for _ in range(cfg.n_layers))
        self.final_norm = layers.empty_param((cfg.d_model,), torch.float32, dev)
        self.lm_head = layers.empty_param((cfg.d_model, cfg.vocab), dt, dev)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _embed(self, tokens: torch.Tensor, offset: int) -> torch.Tensor:
        x = self.embed[tokens]
        if self.cfg.rope_theta == 0:   # sinusoidal absolute positions
            pos = torch.arange(tokens.shape[1], device=x.device) + offset
            x = x + layers.sinusoidal_positions(
                pos, self.cfg.d_model)[None].to(x.dtype)
        return x

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = rmsnorm(x, self.final_norm, self.cfg.norm_eps)
        return (x @ self.lm_head)[:, 0]

    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor, cache_len: Optional[int] = None):
        """(B, S) tokens -> (last-position logits (B, V), cache).  The cache
        is a list with one ring buffer {k, v, kpos} per layer, of capacity
        ``cache_len`` (default S; at most the sliding window)."""
        b, s = tokens.shape
        x = self._embed(tokens, 0)
        positions = _positions_for(self.cfg, b, s, 0, x.device)
        cache = []
        for blk in self.blocks:
            x, c = blk(x, self.cfg, positions, cache_len=cache_len)
            cache.append(c)
        return self._logits(x[:, -1:]), cache

    @torch.inference_mode()
    def decode_step(self, cache: list, token: torch.Tensor, pos: int):
        """One token (B, 1) at absolute position ``pos`` against the cache
        -> (logits (B, V), cache).  The cache is updated in place."""
        b = token.shape[0]
        x = self._embed(token, pos)
        positions = _positions_for(self.cfg, b, 1, pos, x.device)
        for blk, c in zip(self.blocks, cache):
            x, _ = blk(x, self.cfg, positions, cache=c, pos=pos)
        return self._logits(x), cache


def _positions_for(cfg: ArchConfig, batch: int, seq: int, offset: int,
                   device) -> torch.Tensor:
    pos = torch.arange(seq, dtype=torch.int32, device=device)[None, :] + offset
    pos = pos.expand(batch, seq)
    if cfg.mrope_sections is None:
        return pos
    # M-RoPE: vision prefix uses an (h, w) grid with t=0; text advances t.
    p = cfg.n_patches
    g = max(1, int(math.sqrt(max(p, 1))))
    idx = torch.arange(seq, dtype=torch.int32, device=device)[None, :] + offset
    is_text = idx >= p
    t = torch.where(is_text, idx - p, 0)
    hpos = torch.where(is_text, idx - p, idx.clamp(0, max(p - 1, 0)) // g)
    wpos = torch.where(is_text, idx - p, idx.clamp(0, max(p - 1, 0)) % g)
    return torch.stack([t, hpos, wpos]).expand(3, batch, seq)


@torch.no_grad()
def init_params(cfg: ArchConfig, seed: int = 0, device=None) -> Transformer:
    """A :class:`Transformer` with the JAX package's initial scales and
    dtypes, drawn from a ``torch.Generator`` seeded with ``seed`` on the
    model's device: embed N(0, 1)·0.02, lm_head N(0, 1)/sqrt(d), every
    projection N(0, 1)/sqrt(fan_in), norm scales 1.  (The two frameworks
    draw different numbers from one seed.)"""
    model = Transformer(cfg, device)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    d = cfg.d_model
    model.embed.copy_(torch.randn(model.embed.shape, generator=gen,
                                  device=model.device) * 0.02)
    model.final_norm.fill_(1.0)
    model.lm_head.copy_(torch.randn(model.lm_head.shape, generator=gen,
                                    device=model.device) / math.sqrt(d))
    for blk in model.blocks:
        blk.ln1.fill_(1.0)
        blk.ln2.fill_(1.0)
        blk.attn = layers.init_attention(gen, cfg, model.device)
        blk.ffn = layers.init_mlp(gen, cfg, model.device)
    return model


def make_cache(cfg: ArchConfig, batch: int, seq_len: int, device=None) -> list:
    """Decode cache for a context of ``seq_len`` (capacity = window if SWA),
    one ring buffer per layer."""
    dev = resolve_device(device)
    cap = seq_len if cfg.sliding_window is None else min(cfg.sliding_window,
                                                         seq_len)
    return [layers.init_attn_cache(cfg, batch, cap, dev)
            for _ in range(cfg.n_layers)]
