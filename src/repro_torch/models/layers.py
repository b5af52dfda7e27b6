"""Dense building blocks: RMSNorm, RoPE/M-RoPE, GQA attention (causal /
sliding-window / bidirectional), SwiGLU MLP.

The port of the dense part of the JAX package's ``models/layers.py``, under
the same names.  Conventions:
  * activations are (B, S, D); attention heads are (B, S, H, dh);
  * self-attention at prefill goes through the hand-written flash-attention
    kernel (:func:`repro_torch.kernels.attention.flash_attention`; on a CPU
    tensor its plain version); decode, and the plain reference, go through
    :func:`_sdpa_chunked`, the query-chunked exact attention of the JAX
    package;
  * KV caches are ring buffers {k, v, kpos}: ``kpos`` records the absolute
    position held in each slot, which uniformly handles full-cache decode
    (capacity = seq_len) and sliding-window decode (capacity = window).
Cross-attention and the bf16 attention levers (``attn_probs_bf16``,
``attn_scores_bf16``) are not ported and raise.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.attention import flash_attention

ATTN_Q_CHUNK = 1024


def torch_dtype(cfg: ArchConfig) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.dtype]


# ----------------------------------------------------------------- RMSNorm
def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    n = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (n * scale.float()).to(x.dtype)


# -------------------------------------------------------------------- RoPE
def rope_freqs(dh: int, theta: float, device=None) -> torch.Tensor:
    return theta ** (-torch.arange(0, dh // 2, dtype=torch.float32,
                                   device=device) / (dh // 2))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               sections: Optional[tuple[int, int, int]] = None) -> torch.Tensor:
    """x: (B, S, H, dh). positions: (B, S) or (3, B, S) for M-RoPE.

    Rotates split halves (x1 = x[..., :dh/2], x2 = x[..., dh/2:]), in
    float32, and casts back.  M-RoPE (qwen2-vl): the dh/2 rotary
    frequencies are split into (t, h, w) sections, each rotated by its own
    position stream.
    """
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)              # (dh/2,)
    if sections is None:
        ang = positions.float()[..., None] * freqs       # (B,S,dh/2)
    else:
        if positions.dim() != 3:
            raise ValueError(f"M-RoPE needs (3, B, S) positions, got ndim={positions.dim()}")
        parts = []
        start = 0
        for i, sec in enumerate(sections):
            parts.append(positions[i].float()[..., None]
                         * freqs[start:start + sec])
            start += sec
        ang = torch.cat(parts, -1)                        # (B,S,dh/2)
    cos, sin = torch.cos(ang)[:, :, None], torch.sin(ang)[:, :, None]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def sinusoidal_positions(positions: torch.Tensor, d: int) -> torch.Tensor:
    """(..., ) int positions -> (..., d) sinusoidal embedding (whisper)."""
    half = d // 2
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32,
                                    device=positions.device)
                      * math.log(10000.0) / max(half - 1, 1))
    ang = positions.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)


# --------------------------------------------------------------- attention
@dataclasses.dataclass
class AttnMode:
    kind: str                      # "causal" | "bidir" | "cross"
    window: Optional[int] = None


def empty_param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class Attention(nn.Module):
    """The projections of one attention layer, (in, out) as in the JAX
    package: wq (d, H*dh), wk and wv (d, Kh*dh), wo (H*dh, d); with
    ``qk_norm``, q_norm and k_norm (dh,).  All in ``cfg.dtype``."""

    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        d, dh, h, kh = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
        dt = torch_dtype(cfg)
        self.wq = empty_param((d, h * dh), dt, device)
        self.wk = empty_param((d, kh * dh), dt, device)
        self.wv = empty_param((d, kh * dh), dt, device)
        self.wo = empty_param((h * dh, d), dt, device)
        if cfg.qk_norm:
            self.q_norm = empty_param((dh,), dt, device)
            self.k_norm = empty_param((dh,), dt, device)


def init_attention(gen: torch.Generator, cfg: ArchConfig, device) -> Attention:
    p = Attention(cfg, device)
    for w in (p.wq, p.wk, p.wv, p.wo):
        _dense_init_(w, gen)
    if cfg.qk_norm:
        p.q_norm.fill_(1.0)
        p.k_norm.fill_(1.0)
    return p


def _dense_init_(w: torch.Tensor, gen: torch.Generator) -> None:
    """N(0, 1) / sqrt(fan_in) drawn in float32, cast to the weight's dtype
    (the JAX package's ``_dense_init``)."""
    x = torch.randn(w.shape, generator=gen, dtype=torch.float32,
                    device=w.device)
    w.copy_(x * (1.0 / math.sqrt(w.shape[0])))


def _sdpa_chunked(q, k, v, mode: AttnMode, q_offset: int, kpos: torch.Tensor):
    """q: (B,Sq,H,dh); k,v: (B,Sk,Kh,dh); kpos: (Sk,) absolute key positions
    (-1 = empty slot).  Query-chunked exact attention in float32; GQA via
    head grouping: q head h reads kv head h // (H / Kh).

    The plain reference the port keeps beside the flash kernel, and what
    decode runs.  Query rows are taken ``ATTN_Q_CHUNK`` at a time, so the
    S x S scores are never whole."""
    b, sq, h, dh = q.shape
    kh = k.shape[2]
    g = h // kh
    scale = dh ** -0.5
    qg = q.reshape(b, sq, kh, g, dh).float()
    kf, vf = k.float(), v.float()
    outs = []
    for c0 in range(0, sq, ATTN_Q_CHUNK):
        qc = qg[:, c0:c0 + ATTN_Q_CHUNK]
        qpos = q_offset + c0 + torch.arange(qc.shape[1], device=q.device)
        s = torch.einsum("bqkgd,bskd->bkgqs", qc, kf) * scale
        valid = kpos[None, :] >= 0
        if mode.kind == "causal":
            valid = valid & (kpos[None, :] <= qpos[:, None])
        if mode.window is not None:
            valid = valid & (kpos[None, :] > qpos[:, None] - mode.window)
        s = s.masked_fill(~valid, -1e30)
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bkgqs,bskd->bqkgd", p, vf))
    out = torch.cat(outs, 1) if len(outs) > 1 else outs[0]
    return out.reshape(b, sq, h, dh).to(q.dtype)


def _flash_self_attention(q, k, v, mode: AttnMode) -> torch.Tensor:
    """Prefill self-attention through the flash kernel.  q: (B,S,H,dh);
    k, v: (B,S,Kh,dh).  The kv heads are repeated with ``repeat_interleave``
    so that q head h reads kv head h // G, as :func:`_sdpa_chunked` groups
    them; the (B,S,H,dh) <-> (B,H,S,dh) transposes happen here, not in the
    kernel."""
    g = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
    out = flash_attention(qt, kt, vt, causal=mode.kind == "causal",
                          window=mode.window)
    return out.transpose(1, 2)


def attention(p: Attention, x: torch.Tensor, cfg: ArchConfig, *,
              mode: AttnMode, positions: torch.Tensor,
              cache: Optional[dict] = None, pos: Optional[int] = None,
              cache_len: Optional[int] = None):
    """Returns (out, new_cache).  Modes:
       * prefill: cache=None in, a ring cache of capacity ``cache_len``
         (capped at the window) out;
       * decode: cache given, x is (B,1,D), ``pos`` the absolute position.
         The new k, v and position are written into the cache in place (the
         JAX package's ``dynamic_update_slice`` returns a new cache), and
         the same cache is returned.
    """
    if mode.kind == "cross":
        raise NotImplementedError("cross-attention is not ported")
    if cfg.attn_probs_bf16 or cfg.attn_scores_bf16:
        raise NotImplementedError("the bf16 attention levers (attn_probs_bf16, "
                                  "attn_scores_bf16) are not ported")
    b, s, d = x.shape
    h, kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p.wq).reshape(b, s, h, dh)
    k = (x @ p.wk).reshape(b, s, kh, dh)
    v = (x @ p.wv).reshape(b, s, kh, dh)
    if cfg.qk_norm:
        q = rmsnorm(q, p.q_norm, cfg.norm_eps)
        k = rmsnorm(k, p.k_norm, cfg.norm_eps)
    if cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)

    if cache is None:     # prefill (self-attention)
        out = _flash_self_attention(q, k, v, mode)
        cap = s if cache_len is None else cache_len
        if mode.window is not None:
            cap = min(cap, mode.window)
        keep = min(cap, s)
        # ring invariant: position p lives in slot p % cap — align the kept
        # tail so that later decode steps evict the true oldest
        shift = (s - keep) % cap
        tail_pos = torch.arange(s - keep, s, dtype=torch.int32, device=x.device)
        if keep == cap and shift == 0:
            kb, vb = k[:, s - keep:], v[:, s - keep:]
            kposb = tail_pos
        else:
            idx = torch.arange(s - keep, s, device=x.device) % cap
            kb = k.new_zeros((b, cap) + k.shape[2:])
            vb = v.new_zeros((b, cap) + v.shape[2:])
            kb[:, idx] = k[:, s - keep:]
            vb[:, idx] = v[:, s - keep:]
            kposb = torch.full((cap,), -1, dtype=torch.int32, device=x.device)
            kposb[idx] = tail_pos
        new_cache = {"k": kb, "v": vb, "kpos": kposb}
    else:                 # decode (self-attention, ring-buffer cache)
        cap = cache["k"].shape[1]
        slot = pos % cap
        cache["k"][:, slot] = k[:, 0]      # in place
        cache["v"][:, slot] = v[:, 0]
        cache["kpos"][slot] = pos
        out = _sdpa_chunked(q, cache["k"], cache["v"], mode, pos,
                            cache["kpos"])
        new_cache = cache
    y = out.reshape(b, s, h * dh) @ p.wo
    return y, new_cache


def init_attn_cache(cfg: ArchConfig, batch: int, cap: int, device) -> dict:
    dt = torch_dtype(cfg)
    shape = (batch, cap, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
            "kpos": torch.full((cap,), -1, dtype=torch.int32, device=device)}


# --------------------------------------------------------------------- MLP
class MLP(nn.Module):
    """SwiGLU weights in ``cfg.dtype``: wg, wu (d, d_ff), wd (d_ff, d)."""

    def __init__(self, cfg: ArchConfig, device, d_ff: Optional[int] = None):
        super().__init__()
        d, f = cfg.d_model, d_ff or cfg.d_ff
        dt = torch_dtype(cfg)
        self.wg = empty_param((d, f), dt, device)
        self.wu = empty_param((d, f), dt, device)
        self.wd = empty_param((f, d), dt, device)


def init_mlp(gen: torch.Generator, cfg: ArchConfig, device,
             d_ff: Optional[int] = None) -> MLP:
    p = MLP(cfg, device, d_ff)
    for w in (p.wg, p.wu, p.wd):
        _dense_init_(w, gen)
    return p


def mlp(p: MLP, x: torch.Tensor) -> torch.Tensor:
    gate = F.silu((x @ p.wg).float())
    up = x @ p.wu
    return (gate * up.float()).to(x.dtype) @ p.wd
