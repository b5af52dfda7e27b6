"""Dense building blocks: RMSNorm, RoPE/M-RoPE, GQA attention (causal /
sliding-window / bidirectional), SwiGLU MLP, capacity-based MoE.

The port of the JAX package's ``models/layers.py``, under the same names.
Conventions:
  * activations are (B, S, D); attention heads are (B, S, H, dh);
  * attention has three phases, as in the JAX package: at ``"prefill"`` it
    goes through the hand-written flash-attention kernel
    (:func:`repro_torch.kernels.attention.flash_attention`; on a CPU tensor
    its plain version) — causal, bidirectional (whisper's encoder) and
    cross-attention alike; at ``"train"`` through :func:`_sdpa_chunked`
    under autograd — the JAX package's own training route (it
    differentiates its plain ``_sdpa_chunked``; the flash kernel has no
    backward pass in either package); at ``"decode"`` through
    :func:`_sdpa_chunked` over the cache;
  * self-attention KV caches are ring buffers {k, v, kpos}: ``kpos``
    records the absolute position held in each slot, which uniformly
    handles full-cache decode (capacity = seq_len) and sliding-window
    decode (capacity = window); a cross-attention cache is the encoder
    states' projections {k, v}, made once at prefill;
  * the bf16 attention levers (``attn_probs_bf16``, ``attn_scores_bf16``)
    act in :func:`_sdpa_chunked`, so at ``"train"`` and ``"decode"``; the
    flash kernel materialises no S x S tensor, so at ``"prefill"`` they
    change nothing;
  * head counts come from the weights' shapes, not from the config: a
    module whose weights are sharded over a model axis
    (``models/parallel.py::shard_model``) holds its own heads, experts or
    columns, and carries that axis's comm as ``tp``; its input passes
    ``collectives.copy_to_model`` and each row-parallel product (``wo``,
    ``wd``, the MoE's combine) is summed over the axis
    (``collectives.reduce_from_model``).  A module laid out for training
    also holds its FSDP leaves' shards of the data axis, described by
    ``fsdp`` (``collectives.FSDP``), and multiplies by them through
    ``collectives.matmul``.  A module held whole has ``tp = None`` and
    ``fsdp = None`` and runs as on one device.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.attention import flash_attention
from repro_torch.models import collectives
from repro_torch.models.collectives import matmul

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
    """An uninitialised weight, frozen: serving needs no gradients, and
    training makes the model's weights require grad itself
    (``model.requires_grad_()``)."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def model_sum(p: nn.Module, y: torch.Tensor) -> torch.Tensor:
    """A row-parallel product's partial sum summed over the model axis of
    ``p``'s comm (``p.tp``); ``y`` itself for a module held whole."""
    return collectives.reduce_from_model(y, p.tp)


def model_input(p: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The input of a column-parallel region of ``p``: its gradient, which
    each model rank holds in part, is summed over the axis."""
    return collectives.copy_to_model(x, p.tp)


def _draw(shape, gen: torch.Generator, device,
          scale_axis: int = 0) -> torch.Tensor:
    """N(0, 1) / sqrt(fan_in) drawn in float32 (the JAX package's
    ``_dense_init``); the fan-in is ``shape[scale_axis]`` (1 for the (E,
    in, out) expert stacks)."""
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return x * (1.0 / math.sqrt(shape[scale_axis]))


def _dense_init_(w: torch.Tensor, gen: torch.Generator,
                 scale_axis: int = 0) -> None:
    """Fill ``w`` with :func:`_draw` of its shape, cast to its dtype."""
    w.copy_(_draw(w.shape, gen, w.device, scale_axis))


def _fill(module: nn.Module, draws) -> nn.Module:
    """Copy each (name, value) of ``draws`` into the module's parameter
    of that name, cast to its dtype."""
    for name, value in draws:
        module.get_parameter(name).copy_(value)
    return module


class Attention(nn.Module):
    """The projections of one attention layer, (in, out) as in the JAX
    package: wq (d, H*dh), wk and wv (d, Kh*dh), wo (H*dh, d); with
    ``qk_norm``, q_norm and k_norm (dh,).  All in ``cfg.dtype``."""

    tp = None                      # the model axis's comm when sharded
    fsdp = None                    # its leaves sharded over the data axis
    q_first = 0                    # the first of the config's q heads held

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


def attention_draws(gen: torch.Generator, cfg: ArchConfig, device):
    """The attention layer's weights in the order the generator draws
    them: (name, float32 value) pairs, each drawn when it is reached."""
    d, dh, h, kh = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    for name, shape in (("wq", (d, h * dh)), ("wk", (d, kh * dh)),
                        ("wv", (d, kh * dh)), ("wo", (h * dh, d))):
        yield name, _draw(shape, gen, device)
    if cfg.qk_norm:
        yield "q_norm", torch.ones((dh,), device=device)
        yield "k_norm", torch.ones((dh,), device=device)


@torch.no_grad()
def init_attention(gen: torch.Generator, cfg: ArchConfig, device) -> Attention:
    return _fill(Attention(cfg, device), attention_draws(gen, cfg, device))


@functools.lru_cache(maxsize=None)
def _bf16_scale(dh: int) -> float:
    """dh^-0.5 rounded to bfloat16, as the JAX package's bf16 scores
    multiply by ``jnp.asarray(scale, bfloat16)``."""
    return float(torch.tensor(dh ** -0.5, dtype=torch.bfloat16))


def _sdpa_chunked(q, k, v, mode: AttnMode, q_offset: int, kpos: torch.Tensor,
                  probs_bf16: bool = False, scores_bf16: bool = False):
    """q: (B,Sq,H,dh); k,v: (B,Sk,Kh,dh); kpos: (Sk,) absolute key positions
    (-1 = empty slot).  Query-chunked exact attention in float32; GQA via
    head grouping: q head h reads kv head h // (H / Kh).

    The plain reference the port keeps beside the flash kernel, and what
    training (under autograd) and decode run.  Query rows are taken
    ``ATTN_Q_CHUNK`` at a time, so the S x S scores are never whole.

    The bf16 levers, as the JAX package's: ``scores_bf16`` makes and
    stores the scores in bf16 (q and k cast to bf16, the scale rounded to
    bf16) and softmaxes them by hand — max and sum in float32, ``exp`` in
    float32 stored as bf16, the normalised probabilities stored as bf16;
    ``probs_bf16`` casts the float32 softmax to bf16.  With either, P @ V
    reads bf16 P and V and sums in float32 (JAX's
    ``preferred_element_type``): bf16 products are exact in float32."""
    b, sq, h, dh = q.shape
    kh = k.shape[2]
    g = h // kh
    sdt = torch.bfloat16 if scores_bf16 else torch.float32
    scale = _bf16_scale(dh) if scores_bf16 else dh ** -0.5
    qg = q.reshape(b, sq, kh, g, dh).to(sdt)
    kf = k.to(sdt)
    vf = (v.to(torch.bfloat16).float() if scores_bf16 or probs_bf16
          else v.float())
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
        if scores_bf16:
            m = s.amax(-1, keepdim=True).float()
            p = torch.exp(s.float() - m).to(torch.bfloat16)
            denom = p.float().sum(-1, keepdim=True)
            p = (p.float() / denom.clamp(min=1e-30)).to(torch.bfloat16)
        else:
            p = torch.softmax(s, dim=-1)
            if probs_bf16:
                p = p.to(torch.bfloat16)
        outs.append(torch.einsum("bkgqs,bskd->bqkgd", p.float(), vf))
    out = torch.cat(outs, 1) if len(outs) > 1 else outs[0]
    return out.reshape(b, sq, h, dh).to(q.dtype)


def _flash_attention(q, k, v, mode: AttnMode) -> torch.Tensor:
    """Prefill attention through the flash kernel.  q: (B,Sq,H,dh); k, v:
    (B,Sk,Kh,dh), Sk any length (cross-attention reads the encoder's
    frames).  Causal only for a ``"causal"`` mode; a window applies in any
    mode, as in :func:`_sdpa_chunked` (at Sq == Sk the kernel's
    bottom-right alignment is the identity).  The kv heads are repeated
    with ``repeat_interleave`` so that q head h reads kv head h // G, as
    :func:`_sdpa_chunked` groups them; the (B,S,H,dh) <-> (B,H,S,dh)
    transposes happen here, not in the kernel."""
    g = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
    out = flash_attention(qt, kt, vt, causal=mode.kind == "causal",
                          window=mode.window)
    return out.transpose(1, 2)


PHASES = ("train", "prefill", "decode")


def check_phase(phase: str, cache) -> None:
    """Raise ValueError unless ``phase`` is one of PHASES and a cache is
    given exactly when decoding."""
    if phase not in PHASES:
        raise ValueError(f"phase must be one of {PHASES}, got {phase!r}")
    if (cache is not None) != (phase == "decode"):
        raise ValueError(f"phase {phase!r} with cache "
                         f"{'given' if cache is not None else 'None'}: only "
                         f"decode reads a cache")


def attention(p: Attention, x: torch.Tensor, cfg: ArchConfig, *,
              mode: AttnMode, positions: torch.Tensor,
              cache: Optional[dict] = None, pos: Optional[int] = None,
              kv_src: Optional[torch.Tensor] = None,
              cache_len: Optional[int] = None, phase: str = "train"):
    """Returns (out, new_cache).  Phases, as in the JAX package:
       * train: cache=None; the full attention of ``mode`` through the
         plain :func:`_sdpa_chunked`, differentiable; no cache is built
         (None);
       * prefill: cache=None in, attention through the flash kernel, a ring
         cache of capacity ``cache_len`` (capped at the window) out;
       * decode: cache given, x is (B,1,D), ``pos`` the absolute position.
         The new k, v and position are written into the cache in place (the
         JAX package's ``dynamic_update_slice`` returns a new cache), and
         the same cache is returned.
    Cross mode (``mode.kind == "cross"``): q comes from ``x``, k and v from
    the encoder states ``kv_src`` (B, Sk, D) at train and prefill, with no
    RoPE and no mask; prefill returns them as the cache {k, v}, and decode
    reads them from it (the JAX package also projects ``x`` there and
    throws the result away: skipped here, the output is the same).
    The bf16 levers (``cfg.attn_probs_bf16``, ``cfg.attn_scores_bf16``)
    act at train and decode (:func:`_sdpa_chunked`); prefill's flash
    kernel keeps no S x S tensor to cast, so there they change nothing.
    The heads are those ``p`` holds: a model-axis rank's share of them,
    its output summed over the axis.
    """
    check_phase(phase, cache)
    if mode.kind == "cross":
        return _cross_attention(p, x, cfg, cache, kv_src, phase)
    b, s, d = x.shape
    h, kh, dh = _heads(p, cfg)
    x = model_input(p, x)
    q = matmul(p, "wq", x).reshape(b, s, h, dh)
    k = matmul(p, "wk", x).reshape(b, s, kh, dh)
    v = matmul(p, "wv", x).reshape(b, s, kh, dh)
    if cfg.qk_norm:
        q = rmsnorm(q, p.q_norm, cfg.norm_eps)
        k = rmsnorm(k, p.k_norm, cfg.norm_eps)
    if cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)

    if phase == "train":  # the JAX package's training route, autograd
        out = _sdpa(p, cfg, q, k, v, mode, 0,
                    torch.arange(s, device=x.device),
                    cfg.attn_probs_bf16, cfg.attn_scores_bf16)
        new_cache = None
    elif phase == "prefill":
        out = _flash(p, cfg, q, k, v, mode)
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
        out = _sdpa(p, cfg, q, cache["k"], cache["v"], mode, pos,
                    cache["kpos"], cfg.attn_probs_bf16, cfg.attn_scores_bf16)
        new_cache = cache
    y = matmul(p, "wo", out.reshape(b, s, h * dh))
    return model_sum(p, y), new_cache


def _heads(p: Attention, cfg: ArchConfig) -> tuple[int, int, int]:
    """(q heads, kv heads, head dim) of the weights ``p`` holds: the
    config's, or a model-axis rank's share of them."""
    dh = cfg.head_dim
    return p.wq.shape[1] // dh, p.wk.shape[1] // dh, dh


def _kv_of_q(p: Attention, cfg: ArchConfig, h: int, kh: int):
    """The held kv head that each of the ``h`` held q heads reads, where
    they do not read the ``kh`` held kv heads in even groups of h / kh;
    None where they do.  A model rank holds a run of whole q heads from
    ``p.q_first`` on and every kv head they read
    (``models/parallel.py``): where the model axis does not divide the
    heads, a run may straddle two kv heads' groups, or cut one."""
    if p.q_first == 0 and h == cfg.n_heads:
        return None
    g = cfg.n_heads // cfg.n_kv_heads
    first = p.q_first // g
    idx = [(p.q_first + i) // g - first for i in range(h)]
    if h % kh == 0 and idx == [i // (h // kh) for i in range(h)]:
        return None
    return idx


def _by_q_head(p: Attention, cfg: ArchConfig, q, k, v):
    """k, v with one kv head for each q head where the held heads do not
    group evenly (:func:`_kv_of_q`), else as they are."""
    idx = _kv_of_q(p, cfg, q.shape[2], k.shape[2])
    if idx is None:
        return k, v
    idx = torch.tensor(idx, device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def _sdpa(p: Attention, cfg: ArchConfig, q, k, v, *args):
    """:func:`_sdpa_chunked` over the q heads ``p`` holds: none on a
    model rank whose run of heads is empty."""
    if q.shape[2] == 0:
        return q
    return _sdpa_chunked(q, *_by_q_head(p, cfg, q, k, v), *args)


def _flash(p: Attention, cfg: ArchConfig, q, k, v, mode: AttnMode):
    """:func:`_flash_attention` over the q heads ``p`` holds: no launch on
    a model rank whose run of heads is empty."""
    if q.shape[2] == 0:
        return q
    return _flash_attention(q, *_by_q_head(p, cfg, q, k, v), mode)


def _cross_attention(p: Attention, x, cfg: ArchConfig, cache, kv_src, phase):
    """:func:`attention` in cross mode: (out, the cache {k, v}, or None at
    train).  Sharded as self-attention is: ``x`` and ``kv_src`` enter the
    column-parallel region through ``model_input``, every projection goes
    through ``matmul`` (the FSDP gathers in training), ``wo``'s partial sum
    is summed over the model axis; the cache holds the rank's own kv heads
    of its own rows."""
    b, s, d = x.shape
    h, kh, dh = _heads(p, cfg)
    q = matmul(p, "wq", model_input(p, x)).reshape(b, s, h, dh)
    if cfg.qk_norm:
        q = rmsnorm(q, p.q_norm, cfg.norm_eps)
    if cache is not None:          # decode: the encoder's cached k, v
        k, v = cache["k"], cache["v"]
    elif kv_src is None:
        raise ValueError(f"cross-attention at {phase!r} needs the encoder "
                         f"states (kv_src)")
    else:
        sk = kv_src.shape[1]
        kv_src = model_input(p, kv_src)
        k = matmul(p, "wk", kv_src).reshape(b, sk, kh, dh)
        v = matmul(p, "wv", kv_src).reshape(b, sk, kh, dh)
        if cfg.qk_norm:
            k = rmsnorm(k, p.k_norm, cfg.norm_eps)
    mode = AttnMode("bidir")
    if phase == "prefill":
        out = _flash(p, cfg, q, k, v, mode)
    else:
        out = _sdpa(p, cfg, q, k, v, mode, 0,
                    torch.arange(k.shape[1], device=x.device),
                    cfg.attn_probs_bf16, cfg.attn_scores_bf16)
    new_cache = None if phase == "train" else {"k": k, "v": v}
    y = matmul(p, "wo", out.reshape(b, s, h * dh))
    return model_sum(p, y), new_cache


def init_attn_cache(cfg: ArchConfig, batch: int, cap: int, device) -> dict:
    dt = torch_dtype(cfg)
    shape = (batch, cap, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
            "kpos": torch.full((cap,), -1, dtype=torch.int32, device=device)}


def init_cross_cache(cfg: ArchConfig, batch: int, device) -> dict:
    """An empty cross-attention cache: zeros of (B, enc_frames, Kh, dh)."""
    dt = torch_dtype(cfg)
    shape = (batch, cfg.enc_frames, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


# --------------------------------------------------------------------- MLP
class MLP(nn.Module):
    """SwiGLU weights in ``cfg.dtype``: wg, wu (d, d_ff), wd (d_ff, d)."""

    tp = None                      # the model axis's comm when sharded
    fsdp = None                    # its leaves sharded over the data axis

    def __init__(self, cfg: ArchConfig, device, d_ff: Optional[int] = None):
        super().__init__()
        d, f = cfg.d_model, d_ff or cfg.d_ff
        dt = torch_dtype(cfg)
        self.wg = empty_param((d, f), dt, device)
        self.wu = empty_param((d, f), dt, device)
        self.wd = empty_param((f, d), dt, device)


def mlp_draws(gen: torch.Generator, cfg: ArchConfig, device,
              d_ff: Optional[int] = None):
    """The MLP's weights in the generator's order, as
    :func:`attention_draws`."""
    d, f = cfg.d_model, d_ff or cfg.d_ff
    for name, shape in (("wg", (d, f)), ("wu", (d, f)), ("wd", (f, d))):
        yield name, _draw(shape, gen, device)


@torch.no_grad()
def init_mlp(gen: torch.Generator, cfg: ArchConfig, device,
             d_ff: Optional[int] = None) -> MLP:
    return _fill(MLP(cfg, device, d_ff), mlp_draws(gen, cfg, device, d_ff))


def mlp(p: MLP, x: torch.Tensor) -> torch.Tensor:
    return _swiglu(p, model_input(p, x))


def _swiglu(p: MLP, x: torch.Tensor) -> torch.Tensor:
    """The MLP past its region's input."""
    gate = F.silu(matmul(p, "wg", x).float())
    up = matmul(p, "wu", x)
    return model_sum(p, matmul(p, "wd", (gate * up.float()).to(x.dtype)))


# --------------------------------------------------------------------- MoE
def _padded_experts(cfg: ArchConfig) -> int:
    e = cfg.n_experts
    return (e + 15) // 16 * 16 if cfg.pad_experts else e


class MoE(nn.Module):
    """Routed experts in ``cfg.dtype``: router (d, E), we_gate and we_up
    (E_pad, d, d_expert), we_down (E_pad, d_expert, d), with E_pad the
    expert count padded to a multiple of 16 under ``pad_experts`` (dead
    experts the router never names); with ``n_shared_experts``, a shared
    SwiGLU MLP of width n_shared * d_expert.

    Sharded (``models/parallel.py::shard_model``): the stacks hold experts
    ``expert_offset`` onwards (expert parallel, over "model", or over
    "data" under ``expert_data``, where ``experts`` is that axis's comm) or
    every expert's share of d_expert (tensor parallel), ``tp`` is the model
    axis's comm, and ``data`` the data axis's when the batch is split over
    it."""

    tp = None                      # the model axis's comm when sharded
    fsdp = None                    # its leaves sharded over the data axis
    data = None                    # the data axis's comm, batch split
    experts = None                 # the data axis's comm, experts split
    expert_offset = 0              # the first expert the stacks hold

    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        d, e, ep = cfg.d_model, cfg.n_experts, _padded_experts(cfg)
        fe = cfg.d_expert or cfg.d_ff
        dt = torch_dtype(cfg)
        self.router = empty_param((d, e), dt, device)
        self.we_gate = empty_param((ep, d, fe), dt, device)
        self.we_up = empty_param((ep, d, fe), dt, device)
        self.we_down = empty_param((ep, fe, d), dt, device)
        if cfg.n_shared_experts:
            self.shared = MLP(cfg, device, cfg.n_shared_experts * fe)


def moe_draws(gen: torch.Generator, cfg: ArchConfig, device):
    """The JAX package's scales, in the generator's order: router N(0,
    1)/sqrt(d); each expert's matrices N(0, 1)/sqrt(fan_in) with the
    fan-in on axis 1 of the (E, in, out) stacks; the shared MLP as
    :func:`mlp_draws`."""
    d, ep = cfg.d_model, _padded_experts(cfg)
    fe = cfg.d_expert or cfg.d_ff
    yield "router", _draw((d, cfg.n_experts), gen, device)
    for name, shape in (("we_gate", (ep, d, fe)), ("we_up", (ep, d, fe)),
                        ("we_down", (ep, fe, d))):
        yield name, _draw(shape, gen, device, scale_axis=1)
    if cfg.n_shared_experts:
        for name, value in mlp_draws(gen, cfg, device,
                                     cfg.n_shared_experts * fe):
            yield f"shared.{name}", value


@torch.no_grad()
def init_moe(gen: torch.Generator, cfg: ArchConfig, device) -> MoE:
    return _fill(MoE(cfg, device), moe_draws(gen, cfg, device))


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, descending, a
    tie going to the lower index (a stable descending sort keeps equal
    values in index order; ``torch.topk`` promises no tie order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_slots(idx: torch.Tensor, n_experts: int, e_pad: int, cap: int
              ) -> torch.Tensor:
    """The (E_pad, cap) slot table of capacity-based routing: slot (e, r)
    holds the flattened (token, k) index of expert e's r-th assignment in
    token order, or t·k when empty.  Assignments past an expert's capacity
    are dropped: they all write the dump slot E_pad·cap, sliced away (the
    only index written twice).  Padded experts keep all-empty rows."""
    tk = idx.numel()
    dev = idx.device
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)      # jnp.argsort is stable
    sorted_e = flat_e[order]
    seg_start = torch.searchsorted(sorted_e,
                                   torch.arange(n_experts, device=dev))
    rank = torch.arange(tk, device=dev) - seg_start[sorted_e]
    keep = rank < cap
    slot_id = sorted_e * cap + rank.clamp(0, cap - 1)
    slots = torch.full((e_pad * cap + 1,), tk, dtype=torch.long, device=dev)
    slots[torch.where(keep, slot_id, e_pad * cap)] = torch.where(
        keep, order, tk)
    return slots[:e_pad * cap].reshape(e_pad, cap)


def _local_slots(p: MoE, idx: torch.Tensor, cfg: ArchConfig):
    """The slot table of the experts ``p`` holds, over this batch's t·k
    assignments (t·k marks an empty slot), and the whole batch's (T, k)
    choices.  Routing is the whole batch's: with the batch split over the
    data axis (``p.data``), every shard's assignments are gathered and
    routed in batch order under the whole batch's capacity, and this shard
    keeps the slots of its own tokens — so each kept slot is the one a
    single device would keep.  With the experts split over the data axis
    (``p.experts``) the table indexes the whole batch's T·k assignments
    instead, every slot of the rank's experts kept.  Stacks padded past
    the config's experts (to split over "data") hold dead experts, whose
    rows are empty."""
    t, k = idx.shape
    off = 0
    if p.data is not None:
        off = p.data.party_index * t * k
        idx = p.data.all_gather_cat(idx, 0)
    cap = int(math.ceil(idx.shape[0] * k / cfg.n_experts * cfg.moe_capacity))
    n = p.we_gate.shape[0]
    slots = moe_slots(idx, cfg.n_experts,
                      max(_padded_experts(cfg), p.expert_offset + n), cap)
    slots = slots[p.expert_offset:p.expert_offset + n]
    if p.data is not None and p.experts is None:
        mine = (slots >= off) & (slots < off + t * k)
        slots = torch.where(mine, slots - off, t * k)
    return slots, idx


def moe(p: MoE, x: torch.Tensor, cfg: ArchConfig, phase: str = "train"):
    """Capacity-based top-k routing with sort-based grouping, as the JAX
    package's ``moe``: the FLOPs are E × capacity × d × d_expert, with
    capacity = ceil(T·k/E · moe_capacity).  Returns (y, aux_loss); the
    aux loss only at ``phase="train"`` (a float32 zero otherwise: nothing
    reads it there).

    The combine adds each kept slot's gated output into its token with
    ``index_add_`` (JAX: a scatter-add), whose float order is its own, so y
    agrees with the JAX package's to rounding.  ``moe_shard_acts`` is a
    sharding constraint on the dispatch tensors in the JAX package and a
    no-op on one device, as its ``_constrain`` is there: it changes
    nothing here, sharded or not.

    Sharded, every rank of the model axis holds every token and computes
    the same routing (:func:`_local_slots`), runs only its experts' slots
    (or its share of every expert), and the partial combine is summed over
    the axis by one all-reduce; a shared expert's MLP is summed by its
    own.  With the experts split over the data axis (``expert_data``:
    ``p.experts``), a rank gathers the data shards' tokens and gates
    (``collectives.gather_rows``), runs every slot of its own experts over
    the whole batch, and its partial combine of the whole batch's rows is
    summed over "data" keeping its own rows (``collectives.scatter_rows``)
    before the model axis's sum.  A batch that is not split over "data"
    is every data rank's: its tokens pass ``copy_to_model`` and its
    combine ``reduce_from_model`` over the data axis's comm instead.

    The aux loss is the whole batch's, as GSPMD computes the JAX
    package's ``e * (me * ce).sum()`` over a batch split over "data": the
    routed fraction ``ce`` counts the gathered choices, the mean
    probability ``me`` is averaged over the data axis
    (``collectives.batch_mean``).  Every model rank computes the same aux,
    and the model axis sums the gradient it sends back (the router's, and
    the input's through ``copy_to_model``), so each rank passes back its
    share (``collectives.shared_grad``): the aux reaches the router's
    gradient once."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    xf = model_input(p, x.reshape(t, d))
    probs = torch.softmax(matmul(p, "router", xf).float(), -1)
    gate_vals, idx = _top_k(probs, k)                      # (t, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9)

    slots, all_idx = _local_slots(p, idx, cfg)
    xs, gs = xf, gate_vals            # the tokens and gates the slots index
    if p.experts is not None:
        split = p.data is not None
        xs, gs = ((collectives.gather_rows(v, p.data) if split else
                   collectives.copy_to_model(v, p.experts)) for v in (xs, gs))
    n = xs.shape[0]
    tok_of_slot = (slots // k).clamp(0, n - 1)
    slot_valid = slots < n * k

    xe = torch.where(slot_valid[..., None], xs[tok_of_slot], 0)  # (E, cap, d)
    gate_ff = F.silu(matmul(p, "we_gate", xe).float())
    up = matmul(p, "we_up", xe)
    ye = matmul(p, "we_down", (gate_ff * up.float()).to(x.dtype))
    wslot = torch.where(slot_valid,
                        gs.reshape(-1)[slots.clamp(0, n * k - 1)], 0)
    dest = torch.where(slot_valid, tok_of_slot, n).reshape(-1)
    y = ye.new_zeros((n + 1, d)).index_add(
        0, dest, (ye * wslot[..., None]).to(ye.dtype).reshape(-1, d))[:n]
    if p.experts is not None:
        y = (collectives.scatter_rows(y, p.data) if split else
             collectives.reduce_from_model(y, p.experts))
    y = model_sum(p, y)

    if cfg.n_shared_experts:
        # inside the MoE's region when it is model-sharded
        shared_in = xf if p.tp is not None else model_input(p.shared, xf)
        y = y + _swiglu(p.shared, shared_in[None])[0]
    if phase != "train":
        return (y.reshape(b, s, d).to(x.dtype),
                torch.zeros((), dtype=torch.float32, device=x.device))
    # load-balance aux loss (Switch-style), over the whole batch
    me = collectives.shared_grad(collectives.batch_mean(probs.mean(0),
                                                        p.data), p.tp)
    # the routed count of each expert: bincount's, in a shape known before
    # the data (bincount's is the largest index + 1: no fake tensor holds it)
    flat = all_idx.reshape(-1)
    ce = (torch.zeros(e, dtype=torch.int64, device=flat.device)
          .scatter_add_(0, flat, torch.ones_like(flat)).float()
          / all_idx.numel())
    aux = e * (me * ce).sum()
    return y.reshape(b, s, d).to(x.dtype), aux
