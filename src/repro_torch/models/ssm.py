"""Recurrent blocks: Mamba2 (SSD), mLSTM and sLSTM (xLSTM).

The port of the JAX package's ``models/ssm.py``, under the same names and
with the same parameter and cache layouts.  Mamba2 and mLSTM share one
chunked linear recurrence (:func:`chunked_ssd`): within a chunk it is a
decay-masked (L x L) matmul, across chunks a small (H, P, N) state is
carried, so no (B, S, H, P, N) trajectory is ever built.  mLSTM keeps its
normalizer as a second, 1-wide recurrence with the same decay and keys.
sLSTM has a true hidden-to-gate recurrence and runs a step loop over time
(the JAX package's ``lax.scan``).

None of these reach a TPU kernel in the JAX package (they are plain ``jnp``
and ``lax.scan``), so the port is plain PyTorch.  Conventions kept from the
JAX package:
  * the recurrence runs in float32; ``y`` comes back in ``xin``'s dtype and
    the state in float32;
  * bf16 casts where JAX casts: ``xin = xh * dt`` in the activations' dtype,
    silu taken in float32 and cast back;
  * B and C of Mamba2 are shared across heads (n_groups 1): an ``expand``
    view, not a copy;
  * the exponential input gates are ``exp(clip(·, ±8))``.
One difference in the last bits: ``F.softplus`` returns x itself above 20,
where ``jax.nn.softplus`` returns ``log1p(exp(-x)) + x``; they differ by
under 1e-8 relative, far inside every tolerance.

Caches are returned new, never updated in place: Mamba2 {"h" (B, H, P, N)
float32, "conv" (B, K-1, di)}, mLSTM {"h" (B, H, P+1, N)} with the
normalizer's row last, sLSTM {"c", "n", "h"} (B, H, dh) float32.

Widths come from the weights, not from the config, as attention's heads
do (``layers._heads``): a core sharded over a model axis
(``models/parallel.py``) holds the contiguous heads [⌊j·H/m⌋,
⌊(j+1)·H/m⌋) of every per-head quantity (from ``head_first`` on; a run
may be empty where m > H) — its columns of ``in_proj`` (Mamba2's z, x and
dt; mLSTM's z), ``w_in``'s four gates, ``wq wk wi wf``, its rows of
``out_proj``, its channels of ``conv`` and ``out_norm``, its heads of
``a_log dt_bias d_skip`` and ``r`` — and each input every head reads
whole: Mamba2's B and C columns (one group), mLSTM's ``xi`` columns.  It
carries the axis's comm as ``tp``; its input passes
``layers.model_input``, every product ``collectives.matmul`` (the FSDP
gathers in training), ``out_proj``'s partial sum ``layers.model_sum``, and
``out_norm``'s statistic, taken over the whole d_inner, the sum of every
rank's (``collectives.all_sum``).  Its caches then hold its heads (the
conv state its channels).  A core held whole runs the unsharded
operations, bit for bit.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import collectives
from repro_torch.models.collectives import matmul
from repro_torch.models.layers import (_dense_init_, empty_param, model_input,
                                       model_sum, rmsnorm, torch_dtype)

F32 = torch.float32


# ------------------------------------------------------------- chunked SSD
def chunked_ssd(a: torch.Tensor, xin: torch.Tensor, bk: torch.Tensor,
                cq: torch.Tensor, h0: torch.Tensor, chunk: int):
    """Linear recurrence  h_t = a_t·h_{t-1} + xin_t ⊗ bk_t,  y_t = h_t·cq_t.

    a: (B,S,H) per-head decay in (0,1]; xin: (B,S,H,P); bk, cq: (B,S,H,N);
    h0: (B,H,P,N).  Returns (y (B,S,H,P) in xin's dtype, h_final float32).
    S is padded to a chunk multiple with identity steps (a = 1, zero
    inputs).  The three-operand contractions of the JAX package are taken
    as two matrix products each, so no (B, L, H, P, N) tensor is built.

    One deliberate difference from the JAX package: it masks the product,
    ``where(mask, scores * exp(cs_l - cs_m), 0)``, and above the diagonal
    exp(cs_l - cs_m) grows as the chunk's summed log-decay, past float32's
    range once that passes -88 (mLSTM's forget gates at xlstm-350m's chunk
    of 256, from the first step); the forward is right, but the gradient
    takes 0 · inf = NaN there.  Here the mask is taken in the exponent,
    ``scores * exp(where(mask, cs_l - cs_m, -inf))``: the same forward
    values, and a gradient that is finite, equal to the JAX package's
    wherever that is finite (tests/test_torch_ssm.py)."""
    b, s, h, p = xin.shape
    lc = min(chunk, s)
    if s % lc:  # pad to a chunk multiple with identity steps
        pad = lc - s % lc
        a = F.pad(a, (0, 0, 0, pad), value=1.0)
        xin_p = F.pad(xin, (0, 0, 0, 0, 0, pad))
        bk = F.pad(bk, (0, 0, 0, 0, 0, pad))
        cq = F.pad(cq, (0, 0, 0, 0, 0, pad))
    else:
        xin_p = xin
    nc = a.shape[1] // lc
    mask = torch.ones((lc, lc), dtype=torch.bool, device=a.device).tril()
    hcur = h0.to(F32)
    ys = []
    for c in range(nc):
        sl = slice(c * lc, (c + 1) * lc)
        xv = xin_p[:, sl].to(F32).transpose(1, 2)          # (B,H,L,P)
        bv = bk[:, sl].to(F32).transpose(1, 2)             # (B,H,L,N)
        cv = cq[:, sl].to(F32).transpose(1, 2)             # (B,H,L,N)
        la = torch.log(a[:, sl].to(F32).clamp(1e-20, 1.0))
        cs = la.cumsum(1).transpose(1, 2)                  # (B,H,L) inclusive
        # intra-chunk: decay-masked attention matmul (the SSD duality); the
        # mask is taken in the exponent (exp(-inf) = 0), not on the product
        scores = cv @ bv.transpose(-1, -2)                 # (B,H,L,L)
        seg = torch.where(mask, cs[..., :, None] - cs[..., None, :], -math.inf)
        w = scores * torch.exp(seg)
        y = w @ xv                                         # (B,H,L,P)
        # inbound state: (C h^T) scaled by the decay from the chunk start
        y = y + (cv @ hcur.transpose(-1, -2)) * torch.exp(cs)[..., None]
        # outbound state
        tot = cs[..., -1]                                  # (B,H)
        carry = torch.exp(tot[..., None] - cs)             # (B,H,L)
        hcur = (hcur * torch.exp(tot)[..., None, None]
                + (xv * carry[..., None]).transpose(-1, -2) @ bv)
        ys.append(y)
    y = torch.cat(ys, 2).transpose(1, 2)[:, :s]
    return y.to(xin.dtype), hcur


def ssd_decode_step(a, xin, bk, cq, h):
    """Single-token recurrence update. Shapes as chunked_ssd with S=1."""
    af = a.to(F32)[:, 0]                                   # (B,H)
    h_new = (h * af[..., None, None]
             + xin.to(F32)[:, 0, :, :, None] * bk.to(F32)[:, 0, :, None, :])
    y = (h_new @ cq.to(F32)[:, 0, :, :, None])[..., 0]     # (B,H,P)
    return y[:, None].to(xin.dtype), h_new


# -------------------------------------------------------- a core's shares
class _Core(nn.Module):
    """A recurrent core's weights; ``tp`` and ``fsdp`` as ``layers``'
    modules carry them when sharded."""

    tp = None                      # the model axis's comm when sharded
    fsdp = None                    # its leaves sharded over the data axis
    head_first = 0                 # the first of the config's heads held


def _out_norm(p: _Core, y: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """``rmsnorm(y, p.out_norm)`` over the whole d_inner: a rank holding
    some of its channels sums their squares, and the model axis sums the
    rank's sums both ways (``collectives.all_sum``).  A core held whole
    runs :func:`rmsnorm` itself."""
    if collectives._one(p.tp):
        return rmsnorm(y, p.out_norm, cfg.norm_eps)
    yf = y.float()
    ss = collectives.all_sum((yf * yf).sum(-1, keepdim=True), p.tp)
    n = yf * torch.rsqrt(ss / cfg.d_inner + cfg.norm_eps)
    return (n * p.out_norm.float()).to(y.dtype)


# ----------------------------------------------------------------- Mamba2
class Mamba2(_Core):
    """Mamba2 weights, all in ``cfg.dtype`` as in the JAX package:
    in_proj (d, 2di + 2n + H) = [z | x | B | C | dt], conv (K, di), a_log,
    dt_bias, d_skip (H,), out_norm (di,), out_proj (di, d)."""

    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        d, di, n, hh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
        dt = torch_dtype(cfg)
        self.in_proj = empty_param((d, 2 * di + 2 * n + hh), dt, device)
        self.conv = empty_param((cfg.ssm_conv, di), dt, device)
        self.a_log = empty_param((hh,), dt, device)
        self.dt_bias = empty_param((hh,), dt, device)
        self.d_skip = empty_param((hh,), dt, device)
        self.out_norm = empty_param((di,), dt, device)
        self.out_proj = empty_param((di, d), dt, device)


@torch.no_grad()
def init_mamba2(gen: torch.Generator, cfg: ArchConfig, device) -> Mamba2:
    """The JAX package's scales: projections N(0, 1)/sqrt(fan_in), the conv
    half that, A = exp(a_log) = 1, softplus(dt_bias) ≈ 0.13, d_skip and
    out_norm 1."""
    p = Mamba2(cfg, device)
    _dense_init_(p.in_proj, gen)
    _dense_init_(p.conv, gen)
    p.conv.mul_(0.5)
    p.a_log.zero_()
    p.dt_bias.fill_(-2.0)
    p.d_skip.fill_(1.0)
    p.out_norm.fill_(1.0)
    _dense_init_(p.out_proj, gen)
    return p


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor]):
    """Depthwise causal conv. x: (B,S,di); w: (K,di); state: (B,K-1,di).
    Returns (silu(conv) in x's dtype, the new state: the last K-1 inputs,
    a copy)."""
    k, s = w.shape[0], x.shape[1]
    if state is None:
        xp = F.pad(x, (0, 0, k - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], 1)
    out = xp[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s] * w[i]
    return F.silu(out.to(F32)).to(x.dtype), xp[:, -(k - 1):].clone()


def mamba2_block(p: Mamba2, x: torch.Tensor, cfg: ArchConfig, *,
                 cache: Optional[dict] = None):
    """Returns (y, new_cache). cache = {"h": (B,H,P,N), "conv": (B,K-1,di)}.
    Without a cache, or with S > 1, the chunked scan (from a zero state or
    from the cache's); with a cache and S = 1, one decode step."""
    b, s, _ = x.shape
    n, p_dim = cfg.ssm_state, cfg.ssm_head_dim
    hh, di = p.a_log.shape[0], p.conv.shape[1]     # the heads p holds
    zxbcdt = matmul(p, "in_proj", model_input(p, x))
    z, xs, bmat, cmat, dt = torch.split(zxbcdt, [di, di, n, n, hh], -1)
    xs, conv_state = _causal_conv(xs, p.conv,
                                  None if cache is None else cache["conv"])
    dt = F.softplus(dt.to(F32) + p.dt_bias.to(F32))      # (B,S,H)
    a = torch.exp(-dt * torch.exp(p.a_log.to(F32)))
    xh = xs.reshape(b, s, hh, p_dim)
    xin = xh * dt[..., None].to(xh.dtype)
    bk = bmat[:, :, None, :].expand(b, s, hh, n)
    cq = cmat[:, :, None, :].expand(b, s, hh, n)

    if cache is None or s > 1:
        h0 = (torch.zeros((b, hh, p_dim, n), dtype=F32, device=x.device)
              if cache is None else cache["h"])
        y, h_fin = chunked_ssd(a, xin, bk, cq, h0, cfg.ssm_chunk)
    else:
        y, h_fin = ssd_decode_step(a, xin, bk, cq, cache["h"])

    y = y + xh * p.d_skip.to(F32).reshape(1, 1, hh, 1).to(xh.dtype)
    y = y.reshape(b, s, di)
    y = _out_norm(p, y, cfg)
    y = y * F.silu(z.to(F32)).to(y.dtype)
    return (model_sum(p, matmul(p, "out_proj", y)),
            {"h": h_fin, "conv": conv_state})


def init_mamba2_cache(cfg: ArchConfig, batch: int, device) -> dict:
    return {"h": torch.zeros((batch, cfg.n_ssm_heads, cfg.ssm_head_dim,
                              cfg.ssm_state), dtype=F32, device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner),
                                dtype=torch_dtype(cfg), device=device)}


# ------------------------------------------------------------------ mLSTM
class MLSTM(_Core):
    """mLSTM weights in ``cfg.dtype``: in_proj (d, 2di), wq and wk
    (di, H·N), wi and wf (di, H), out_norm (di,), out_proj (di, d)."""

    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        d, di, n, hh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
        dt = torch_dtype(cfg)
        self.in_proj = empty_param((d, 2 * di), dt, device)
        self.wq = empty_param((di, hh * n), dt, device)
        self.wk = empty_param((di, hh * n), dt, device)
        self.wi = empty_param((di, hh), dt, device)
        self.wf = empty_param((di, hh), dt, device)
        self.out_norm = empty_param((di,), dt, device)
        self.out_proj = empty_param((di, d), dt, device)


@torch.no_grad()
def init_mlstm(gen: torch.Generator, cfg: ArchConfig, device) -> MLSTM:
    p = MLSTM(cfg, device)
    for w in (p.in_proj, p.wq, p.wk, p.wi, p.wf):
        _dense_init_(w, gen)
    p.out_norm.fill_(1.0)
    _dense_init_(p.out_proj, gen)
    return p


def mlstm_block(p: MLSTM, x: torch.Tensor, cfg: ArchConfig, *,
                cache: Optional[dict] = None):
    """Matrix-memory LSTM: the values and the 1-wide normalizer as two
    recurrences sharing the forget-gate decay and the keys.
    cache = {"h": (B,H,P+1,N)}, the normalizer's state as the last row."""
    b, s, _ = x.shape
    n, p_dim = cfg.ssm_state, cfg.d_inner // cfg.n_ssm_heads
    hh = p.wi.shape[1]                             # the heads p holds
    di = hh * p_dim
    xi, z = torch.split(matmul(p, "in_proj", model_input(p, x)),
                        [cfg.d_inner, di], -1)     # xi whole, z its heads'
    q = matmul(p, "wq", xi).reshape(b, s, hh, n)
    k = matmul(p, "wk", xi).reshape(b, s, hh, n) / math.sqrt(n)
    igate = torch.exp(matmul(p, "wi", xi).to(F32).clamp(-8.0, 8.0))
    fgate = torch.sigmoid(matmul(p, "wf", xi).to(F32))
    lo = p.head_first * p_dim                      # its heads' values
    v = xi[..., lo:lo + di].reshape(b, s, hh, p_dim)
    ig = igate[..., None].to(v.dtype)                     # (B,S,H,1)
    vin = v * ig
    nin = ig                       # the JAX package's ig[..., :1] * ones
    f = fgate.to(x.dtype)

    if cache is None or s > 1:
        if cache is None:
            hv0 = torch.zeros((b, hh, p_dim, n), dtype=F32, device=x.device)
            hn0 = torch.zeros((b, hh, 1, n), dtype=F32, device=x.device)
        else:
            hv0, hn0 = cache["h"][:, :, :p_dim], cache["h"][:, :, p_dim:]
        yv, hv = chunked_ssd(f, vin, k, q, hv0, cfg.ssm_chunk)
        yn, hn = chunked_ssd(f, nin, k, q, hn0, cfg.ssm_chunk)
    else:
        hv0, hn0 = cache["h"][:, :, :p_dim], cache["h"][:, :, p_dim:]
        yv, hv = ssd_decode_step(f, vin, k, q, hv0)
        yn, hn = ssd_decode_step(f, nin, k, q, hn0)
    h_fin = torch.cat([hv, hn], 2)       # keep the cache layout (P+1, N)
    denom = yn[..., 0]
    yv = yv / denom.abs().clamp(min=1.0)[..., None]
    yv = yv.reshape(b, s, di)
    yv = _out_norm(p, yv, cfg)
    yv = yv * F.silu(z.to(F32)).to(yv.dtype)
    return model_sum(p, matmul(p, "out_proj", yv)), {"h": h_fin}


def init_mlstm_cache(cfg: ArchConfig, batch: int, device) -> dict:
    hh = cfg.n_ssm_heads
    return {"h": torch.zeros((batch, hh, cfg.d_inner // hh + 1,
                              cfg.ssm_state), dtype=F32, device=device)}


# ------------------------------------------------------------------ sLSTM
class SLSTM(_Core):
    """sLSTM weights in ``cfg.dtype``: w_in (d, 4di) = the i, f, z, o
    pre-activations, r (4, H, dh, dh) the per-head recurrence, in_norm
    (d,), out_norm (di,), out_proj (di, d)."""

    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        d, di, hh = cfg.d_model, cfg.d_inner, cfg.n_ssm_heads
        dh = di // hh
        dt = torch_dtype(cfg)
        self.w_in = empty_param((d, 4 * di), dt, device)
        self.r = empty_param((4, hh, dh, dh), dt, device)
        self.in_norm = empty_param((d,), dt, device)
        self.out_norm = empty_param((di,), dt, device)
        self.out_proj = empty_param((di, d), dt, device)


@torch.no_grad()
def init_slstm(gen: torch.Generator, cfg: ArchConfig, device) -> SLSTM:
    """r's fan-in is its axis 2 (the hidden state it multiplies)."""
    p = SLSTM(cfg, device)
    _dense_init_(p.w_in, gen)
    _dense_init_(p.r, gen, scale_axis=2)
    p.in_norm.fill_(1.0)
    p.out_norm.fill_(1.0)
    _dense_init_(p.out_proj, gen)
    return p


def _slstm_cell(r: torch.Tensor, pre: torch.Tensor, state):
    """One sLSTM step. r: (4,H,dh,dh) float32; pre: (B,4,H,dh) float32
    pre-activations; state: (c, n, h), each (B,H,dh) float32."""
    c, nrm, h = state
    rec = torch.matmul(h.transpose(0, 1)[None], r).permute(2, 0, 1, 3)
    g = pre + rec                                          # (B,4,H,dh)
    i = torch.exp(g[:, 0].clamp(-8.0, 8.0))
    f = torch.sigmoid(g[:, 1])
    z = torch.tanh(g[:, 2])
    o = torch.sigmoid(g[:, 3])
    c_new = f * c + i * z
    n_new = f * nrm + i
    h_new = o * c_new / n_new.abs().clamp(min=1.0)
    return (c_new, n_new, h_new)


def slstm_block(p: SLSTM, x: torch.Tensor, cfg: ArchConfig, *,
                cache: Optional[dict] = None):
    """True recurrence: a step loop over time (the JAX package's
    ``lax.scan``), about 16 small kernels a step.
    cache = {"c", "n", "h"} (B,H,dh)."""
    b, s, _ = x.shape
    hh = p.r.shape[1]                              # the heads p holds
    dh = cfg.d_inner // cfg.n_ssm_heads
    xn = model_input(p, rmsnorm(x, p.in_norm, cfg.norm_eps))
    pre = matmul(p, "w_in", xn).to(F32).reshape(b, s, 4, hh, dh)
    r = collectives.weight(p, "r").to(F32)
    if cache is None:
        st = tuple(torch.zeros((b, hh, dh), dtype=F32, device=x.device)
                   for _ in range(3))
    else:
        st = (cache["c"], cache["n"], cache["h"])
    ys = []
    for t in range(s):
        st = _slstm_cell(r, pre[:, t], st)
        ys.append(st[2])
    y = torch.stack(ys, 1).reshape(b, s, hh * dh).to(x.dtype)
    y = _out_norm(p, y, cfg)
    return (model_sum(p, matmul(p, "out_proj", y)),
            {"c": st[0], "n": st[1], "h": st[2]})


def init_slstm_cache(cfg: ArchConfig, batch: int, device) -> dict:
    hh = cfg.n_ssm_heads
    shape = (batch, hh, cfg.d_inner // hh)
    return {k: torch.zeros(shape, dtype=F32, device=device)
            for k in ("c", "n", "h")}


# ---------------------------------------------------------- by block kind
CORES = {"mamba2": Mamba2, "mlstm": MLSTM, "slstm": SLSTM}
INITS = {"mamba2": init_mamba2, "mlstm": init_mlstm, "slstm": init_slstm}
BLOCKS = {"mamba2": mamba2_block, "mlstm": mlstm_block,
          "slstm": slstm_block}
CACHES = {"mamba2": init_mamba2_cache, "mlstm": init_mlstm_cache,
          "slstm": init_slstm_cache}
