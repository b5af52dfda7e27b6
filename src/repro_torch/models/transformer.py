"""Model assembly: embed -> blocks -> norm -> lm_head.

The port of the JAX package's ``models/transformer.py`` for the dense, MoE,
SSM (xLSTM) and hybrid (Mamba2 + shared attention) families.  The JAX
package scans over stacked pattern units and then runs the unscanned tail
blocks; here :class:`Transformer` holds one module per layer in a
``ModuleList`` (units in order, then the tail; :func:`layer_kinds`) and
loops over them.  Block kinds, as in the JAX package:
  * ``attn``: :class:`Block`, attention then the MLP or MoE;
  * ``mamba2`` / ``mlstm`` / ``slstm``: :class:`SSMBlock`, ``ln`` then the
    recurrent core of :mod:`repro_torch.models.ssm`;
  * ``attn_shared``: :class:`SharedAttnUse`, a use of the model's one
    weight-tied attention block ``shared_attn`` (zamba2): the weights are
    held once (``named_parameters`` lists them once, so AdamW updates them
    once and autograd sums their gradient over the uses), each use has its
    own KV cache.

Entry points, matching the JAX package's:
  * :meth:`Transformer.forward_train` — full-sequence causal logits and the
                                        MoE aux loss, differentiable;
  * :func:`lm_loss`                   — next-token cross-entropy + 0.01·aux;
  * :meth:`Transformer.prefill`       — logits for the last position and a
                                        populated ring-buffer KV cache;
  * :meth:`Transformer.decode_step`   — ONE token against that cache;
  * :func:`make_cache`                — an empty cache for decode alone.
Encoder-decoder and VLM configurations raise NotImplementedError
(:func:`check_supported`).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import BLOCK_KINDS, ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers, ssm
from repro_torch.models.layers import AttnMode, attention, mlp, moe, rmsnorm


def check_supported(cfg: ArchConfig) -> None:
    """Raise NotImplementedError for what the port's model does not run."""
    unknown = [k for k in cfg.pattern if k not in BLOCK_KINDS]
    why = []
    if unknown:
        why.append(f"block kinds {sorted(set(unknown))}")
    if cfg.enc_layers:
        why.append(f"enc_layers={cfg.enc_layers} (encoder-decoder)")
    if cfg.cross_attention:
        why.append("cross_attention")
    if cfg.n_patches:
        why.append(f"n_patches={cfg.n_patches} (VLM)")
    if why:
        raise NotImplementedError(
            f"{cfg.name}: the port runs decoder-only models (dense, MoE, "
            f"SSM, hybrid); not ported: {', '.join(why)}")


def layer_kinds(cfg: ArchConfig) -> list[str]:
    """The block kind of each layer: the pattern over ``n_units`` units,
    then the tail blocks."""
    return list(cfg.pattern) * cfg.n_units + list(cfg.tail_blocks)


# the remat policies of the JAX package that save chosen tensors; only
# src/repro/launch/perf.py sets them
_REMAT_POLICIES = ("dots", "attn_out")


class Block(nn.Module):
    """One layer: ln1 -> attention -> residual, ln2 -> FFN -> residual.
    The FFN is the MoE (:class:`layers.MoE`) when ``cfg.n_experts``, else
    the SwiGLU MLP.  ``ln1``/``ln2`` are float32 scales."""

    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        self.ln1 = layers.empty_param((cfg.d_model,), torch.float32, device)
        self.ln2 = layers.empty_param((cfg.d_model,), torch.float32, device)
        self.attn = layers.Attention(cfg, device)
        self.ffn = (layers.MoE(cfg, device) if cfg.n_experts
                    else layers.MLP(cfg, device))

    def forward(self, x, cfg: ArchConfig, positions, *, phase: str,
                cache=None, pos=None, cache_len=None):
        """Returns (x, new_cache, aux): aux is the MoE's load-balance loss,
        a float32 zero for a dense block."""
        mode = AttnMode("causal", window=cfg.sliding_window)
        h = rmsnorm(x, self.ln1, cfg.norm_eps)
        out, new_cache = attention(self.attn, h, cfg, mode=mode,
                                   positions=positions, cache=cache, pos=pos,
                                   cache_len=cache_len, phase=phase)
        x = x + out
        h = rmsnorm(x, self.ln2, cfg.norm_eps)
        if cfg.n_experts:
            out, aux = moe(self.ffn, h, cfg)
        else:
            out = mlp(self.ffn, h)
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return x + out, new_cache, aux


class SSMBlock(nn.Module):
    """One recurrent layer: ln -> core (Mamba2, mLSTM or sLSTM) ->
    residual.  ``ln`` is a float32 scale, the core's weights
    ``cfg.dtype``."""

    def __init__(self, kind: str, cfg: ArchConfig, device):
        super().__init__()
        self.kind = kind
        self.ln = layers.empty_param((cfg.d_model,), torch.float32, device)
        self.core = ssm.CORES[kind](cfg, device)

    def forward(self, x, cfg: ArchConfig, positions, *, phase: str,
                cache=None, pos=None, cache_len=None):
        """Returns (x, new_cache, aux 0): training and prefill run the
        chunked scan (or sLSTM's step loop) from a zero state, decode
        (x of one token) one step from ``cache``."""
        layers.check_phase(phase, cache)
        h = rmsnorm(x, self.ln, cfg.norm_eps)
        out, new_cache = ssm.BLOCKS[self.kind](self.core, h, cfg, cache=cache)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return x + out, new_cache, aux


class SharedAttnUse(nn.Module):
    """A use of the model's weight-tied attention block (``attn_shared``):
    no weights of its own; :class:`Transformer` runs its ``shared_attn``
    here, with this layer's cache."""


class Transformer(nn.Module):
    """A decoder-only LM with uninitialised weights on ``device`` (``None``:
    the CUDA card).  Fill it with :func:`init_params` or
    :func:`repro_torch.convert.lm_params_from_numpy`.

    Weights follow the JAX package's layout and dtypes: ``embed`` (V, d)
    and ``lm_head`` (d, V) in ``cfg.dtype``, ``final_norm`` float32; one
    module a layer in ``blocks`` (:func:`layer_kinds`), and ``shared_attn``
    when the pattern has ``attn_shared``."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        check_supported(cfg)
        dev = resolve_device(device)
        dt = layers.torch_dtype(cfg)
        self.cfg = cfg
        kinds = layer_kinds(cfg)
        self.embed = layers.empty_param((cfg.vocab, cfg.d_model), dt, dev)
        self.blocks = nn.ModuleList(
            Block(cfg, dev) if kind == "attn"
            else SharedAttnUse() if kind == "attn_shared"
            else SSMBlock(kind, cfg, dev) for kind in kinds)
        self.final_norm = layers.empty_param((cfg.d_model,), torch.float32, dev)
        self.lm_head = layers.empty_param((cfg.d_model, cfg.vocab), dt, dev)
        if "attn_shared" in kinds:
            self.shared_attn = Block(cfg, dev)

    def _layer(self, i: int) -> nn.Module:
        """The module that runs layer i (the shared block for a use)."""
        blk = self.blocks[i]
        return self.shared_attn if isinstance(blk, SharedAttnUse) else blk

    def _train_layers(self, lo: int, hi: int, x, positions):
        """Layers lo..hi-1 in the training phase: (x, summed aux), what
        remat checkpoints."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(lo, hi):
            x, _, a = self._layer(i)(x, self.cfg, positions, phase="train")
            aux = aux + a
        return x, aux

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

    def forward_train(self, tokens: torch.Tensor):
        """(B, S) tokens -> ((B, S, V) logits, aux loss), differentiable
        in the weights once they require grad (``self.requires_grad_()``;
        the training step does it).

        Attention runs the training phase (the plain ``_sdpa_chunked``,
        never the flash kernel); the MoE aux losses of all layers are
        summed (float32).  ``cfg.remat``, as the JAX package's
        ``_run_stack``: ``"unit"`` checkpoints each pattern unit (its
        activations are recomputed in the backward pass; the tail blocks
        are not checkpointed), ``"none"`` keeps them."""
        cfg = self.cfg
        if cfg.remat in _REMAT_POLICIES:
            raise NotImplementedError(
                f"remat={cfg.remat!r} (a policy that saves chosen tensors) "
                f"is not ported: ROADMAP Queue 1 item 6")
        if cfg.remat not in ("unit", "none"):
            raise ValueError(f"unknown remat {cfg.remat!r}")
        b, s = tokens.shape
        x = self._embed(tokens, 0)
        positions = _positions_for(cfg, b, s, 0, x.device)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        n_pat = len(cfg.pattern)
        spans = [(u * n_pat, (u + 1) * n_pat, cfg.remat == "unit")
                 for u in range(cfg.n_units)]
        spans += [(i, i + 1, False)
                  for i in range(cfg.n_units * n_pat, cfg.n_layers)]
        for lo, hi, remat in spans:
            if remat:
                x, a = checkpoint(self._train_layers, lo, hi, x, positions,
                                  use_reentrant=False)
            else:
                x, a = self._train_layers(lo, hi, x, positions)
            aux = aux + a
        x = rmsnorm(x, self.final_norm, cfg.norm_eps)
        return x @ self.lm_head, aux

    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor, cache_len: Optional[int] = None):
        """(B, S) tokens -> (last-position logits (B, V), cache).  The cache
        is a list with one entry per layer: a ring buffer {k, v, kpos} of
        capacity ``cache_len`` (default S; at most the sliding window) for
        an attention layer (each use of a shared block has its own), the
        recurrent state after the S tokens for an SSM layer
        (:mod:`repro_torch.models.ssm`)."""
        b, s = tokens.shape
        x = self._embed(tokens, 0)
        positions = _positions_for(self.cfg, b, s, 0, x.device)
        cache = []
        for i in range(len(self.blocks)):
            x, c, _ = self._layer(i)(x, self.cfg, positions, phase="prefill",
                                     cache_len=cache_len)
            cache.append(c)
        return self._logits(x[:, -1:]), cache

    @torch.inference_mode()
    def decode_step(self, cache: list, token: torch.Tensor, pos: int):
        """One token (B, 1) at absolute position ``pos`` against the cache
        -> (logits (B, V), cache).  The cache list is updated in place: an
        attention layer's ring buffer is written in place, an SSM layer's
        entry is replaced by its new state."""
        b = token.shape[0]
        x = self._embed(token, pos)
        positions = _positions_for(self.cfg, b, 1, pos, x.device)
        for i in range(len(self.blocks)):
            x, cache[i], _ = self._layer(i)(x, self.cfg, positions,
                                            phase="decode", cache=cache[i],
                                            pos=pos)
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
    projection N(0, 1)/sqrt(fan_in) (the MoE's as ``layers.init_moe``, the
    recurrent cores' as ``ssm.INITS``), norm scales 1.  (The two frameworks
    draw different numbers from one seed.)"""
    model = Transformer(cfg, device)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    d = cfg.d_model
    model.embed.copy_(torch.randn(model.embed.shape, generator=gen,
                                  device=model.device) * 0.02)
    model.final_norm.fill_(1.0)
    model.lm_head.copy_(torch.randn(model.lm_head.shape, generator=gen,
                                    device=model.device) / math.sqrt(d))
    attn_blocks = [b for b in model.blocks if isinstance(b, Block)]
    if hasattr(model, "shared_attn"):
        attn_blocks.append(model.shared_attn)
    for blk in attn_blocks:
        blk.ln1.fill_(1.0)
        blk.ln2.fill_(1.0)
        blk.attn = layers.init_attention(gen, cfg, model.device)
        blk.ffn = (layers.init_moe(gen, cfg, model.device) if cfg.n_experts
                   else layers.init_mlp(gen, cfg, model.device))
    for blk in model.blocks:
        if isinstance(blk, SSMBlock):
            blk.ln.fill_(1.0)
            blk.core = ssm.INITS[blk.kind](gen, cfg, model.device)
    return model


def lm_loss(model: Transformer, batch: dict):
    """Next-token cross-entropy over ``batch["tokens"]`` plus 0.01·aux, as
    the JAX package's ``lm_loss``: labels are the tokens shifted left and
    padded with 0, the last position masked out, the log-sum-exp taken in
    float32.  Returns (loss, (ce, aux))."""
    if set(batch) != {"tokens"}:
        raise NotImplementedError(
            f"{model.cfg.name}: only token batches are trained "
            f"(got {sorted(batch)})")
    tokens = batch["tokens"]
    logits, aux = model.forward_train(tokens)
    labels = F.pad(tokens[:, 1:], (0, 1))
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels[..., None])[..., 0]
    mask = torch.ones_like(gold)
    mask[:, -1] = 0.0
    ce = ((lse - gold) * mask).sum() / mask.sum()
    return ce + 0.01 * aux, (ce, aux)


def make_cache(cfg: ArchConfig, batch: int, seq_len: int, device=None) -> list:
    """Decode cache for a context of ``seq_len`` (capacity = window if SWA):
    per layer, an empty ring buffer for attention (each shared-block use
    too), a zero state for an SSM block."""
    dev = resolve_device(device)
    cap = seq_len if cfg.sliding_window is None else min(cfg.sliding_window,
                                                         seq_len)
    return [layers.init_attn_cache(cfg, batch, cap, dev)
            if kind in ("attn", "attn_shared")
            else ssm.CACHES[kind](cfg, batch, dev)
            for kind in layer_kinds(cfg)]
