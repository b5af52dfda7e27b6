"""Model assembly: embed -> blocks -> norm -> lm_head.

The port of the JAX package's ``models/transformer.py`` for all its
families: dense, MoE, SSM (xLSTM), hybrid (Mamba2 + shared attention),
encoder-decoder audio (whisper) and VLM (qwen2-vl).  The JAX
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

The encoder-decoder (``cfg.enc_layers``) also holds ``enc_blocks``, the
bidirectional encoder over the ``frames`` stub (B, enc_frames, d): each
decoder block then has ``ln_cross`` and ``cross``, attention from the
decoder to the encoder's output.  The encoder's final norm is the model's
``final_norm``, held once, as the JAX package uses the decoder's own
parameter for it (its gradient sums both uses).  The VLM
(``cfg.n_patches``) projects the ``patches`` stub through ``vision_proj``
into the first ``n_patches`` positions; M-RoPE positions put them on an
(h, w) grid.  Both stubs come in a batch's non-token keys, the ``extras``.

Entry points, matching the JAX package's:
  * :meth:`Transformer.forward_train` — full-sequence causal logits and the
                                        MoE aux loss, differentiable;
  * :func:`lm_loss`                   — next-token cross-entropy + 0.01·aux;
  * :meth:`Transformer.prefill`       — logits for the last position and a
                                        populated ring-buffer KV cache;
  * :meth:`Transformer.decode_step`   — ONE token against that cache;
  * :func:`make_cache`                — an empty cache for decode alone.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import BLOCK_KINDS, ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import collectives, layers, ssm
from repro_torch.models.layers import AttnMode, attention, mlp, moe, rmsnorm


def check_supported(cfg: ArchConfig) -> None:
    """Raise NotImplementedError for a block kind the port's model does not
    run (every configuration of the registry is supported)."""
    unknown = [k for k in cfg.pattern if k not in BLOCK_KINDS]
    if unknown:
        raise NotImplementedError(
            f"{cfg.name}: block kinds {sorted(set(unknown))} are not ported")


def layer_kinds(cfg: ArchConfig) -> list[str]:
    """The block kind of each layer: the pattern over ``n_units`` units,
    then the tail blocks."""
    return list(cfg.pattern) * cfg.n_units + list(cfg.tail_blocks)


@torch.library.custom_op("repro_torch::attn_out", mutates_args=())
def attn_out(x: torch.Tensor) -> torch.Tensor:
    """The identity, as an operator of its own: the self-attention output
    before the residual add carries it where the ``"attn_out"`` remat
    policy runs, so that the policy can name the tensor to save (the JAX
    package's ``checkpoint_name(out, "attn_out")``).  A custom operator
    returns no alias of its input: a copy."""
    return x.clone()


@attn_out.register_fake
def _(x):
    return torch.empty_like(x)


attn_out.register_autograd(lambda ctx, g: g)

# ``cfg.remat`` -> what a checkpointed unit keeps for the backward pass, as
# the JAX package's ``_run_stack`` sets its policies: "unit" nothing (it
# recomputes the unit), "dots" the products with no batch dimensions
# (``dots_with_no_batch_dims_saveable``: eager ``x @ W`` reaches
# ``aten.mm``, ``addmm`` with a bias; the attention einsums and the expert
# stacks are ``bmm``s and recomputed, as their batch dimensions make them
# in JAX), "attn_out" the marked attention output alone
# (``save_only_these_names("attn_out")``)
REMAT_SAVES = {"unit": None,
               "dots": (torch.ops.aten.mm.default,
                        torch.ops.aten.addmm.default),
               "attn_out": (torch.ops.repro_torch.attn_out.default,)}


def _remat(policy: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` checkpointed under ``policy`` (a key of
    :data:`REMAT_SAVES`); every rank recomputes the same operations, its
    collectives included, in the same order."""
    saves = REMAT_SAVES[policy]
    if saves is None:
        return checkpoint(fn, *args, use_reentrant=False, **kwargs)
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=functools.partial(
                          create_selective_checkpoint_contexts, list(saves)),
                      **kwargs)


class Block(nn.Module):
    """One layer: ln1 -> attention -> residual, [ln_cross -> cross-attention
    -> residual,] ln2 -> FFN -> residual.  The FFN is the MoE
    (:class:`layers.MoE`) when ``cfg.n_experts``, else the SwiGLU MLP; an
    encoder block (``bidir``) attends both ways and always takes the MLP; a
    decoder block of an encoder-decoder (``cfg.cross_attention``) has the
    cross-attention.  ``ln*`` are float32 scales."""

    def __init__(self, cfg: ArchConfig, device, bidir: bool = False):
        super().__init__()
        self.bidir = bidir
        self.ln1 = layers.empty_param((cfg.d_model,), torch.float32, device)
        self.ln2 = layers.empty_param((cfg.d_model,), torch.float32, device)
        self.attn = layers.Attention(cfg, device)
        self.ffn = (layers.MoE(cfg, device) if cfg.n_experts and not bidir
                    else layers.MLP(cfg, device))
        if cfg.cross_attention and not bidir:
            self.ln_cross = layers.empty_param((cfg.d_model,), torch.float32,
                                               device)
            self.cross = layers.Attention(cfg, device)

    def forward(self, x, cfg: ArchConfig, positions, *, phase: str,
                cache=None, pos=None, cache_len=None, enc_out=None):
        """Returns (x, new_cache, aux): aux is the MoE's load-balance loss,
        a float32 zero for a dense block.  With cross-attention the cache is
        {"self": ring, "cross": {k, v}} (None at train), and ``enc_out`` the
        encoder's output at train and prefill."""
        mode = AttnMode("bidir" if self.bidir else "causal",
                        window=cfg.sliding_window)
        has_cross = hasattr(self, "cross")
        h = rmsnorm(x, self.ln1, cfg.norm_eps)
        out, new_cache = attention(
            self.attn, h, cfg, mode=mode, positions=positions,
            cache=cache["self"] if has_cross and cache is not None else cache,
            pos=pos, cache_len=cache_len, phase=phase)
        if phase == "train" and cfg.remat == "attn_out":
            out = attn_out(out)
        x = x + out
        if has_cross:
            h = rmsnorm(x, self.ln_cross, cfg.norm_eps)
            out, cross_cache = attention(
                self.cross, h, cfg, mode=AttnMode("cross"),
                positions=positions,
                cache=None if cache is None else cache["cross"],
                kv_src=enc_out, phase=phase)
            x = x + out
            if phase != "train":
                new_cache = {"self": new_cache, "cross": cross_cache}
        h = rmsnorm(x, self.ln2, cfg.norm_eps)
        if cfg.n_experts and not self.bidir:
            out, aux = moe(self.ffn, h, cfg, phase)
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
                cache=None, pos=None, cache_len=None, enc_out=None):
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
    """An LM with uninitialised weights on ``device`` (``None``: the CUDA
    card).  Fill it with :func:`init_params` or
    :func:`repro_torch.convert.lm_params_from_numpy`.

    Weights follow the JAX package's layout and dtypes: ``embed`` (V, d)
    and ``lm_head`` (d, V) in ``cfg.dtype``, ``final_norm`` float32; one
    module a layer in ``blocks`` (:func:`layer_kinds`), ``shared_attn``
    when the pattern has ``attn_shared``, the ``enc_layers`` encoder blocks
    in ``enc_blocks``, and ``vision_proj`` (d, d) in ``cfg.dtype`` for a
    VLM.  A model sharded (``models/parallel.py::shard_model``) holds a
    rank's slices of these and its model axis's comm as ``tp``; laid out
    for training, also its FSDP leaves (``fsdp``) and the step's gradient
    reductions (``layout``, ``parallel.TrainLayout``)."""

    tp = None          # the model axis's comm of a sharded model
    fsdp = None        # embed's and lm_head's shards over the data axis
    layout = None      # a model sharded for training: its TrainLayout

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
        if cfg.enc_layers:
            self.enc_blocks = nn.ModuleList(
                Block(cfg, dev, bidir=True) for _ in range(cfg.enc_layers))
        if cfg.n_patches:
            self.vision_proj = layers.empty_param((cfg.d_model, cfg.d_model),
                                                  dt, dev)

    def _layer(self, i: int) -> nn.Module:
        """The module that runs layer i (the shared block for a use)."""
        blk = self.blocks[i]
        return self.shared_attn if isinstance(blk, SharedAttnUse) else blk

    def _train_layers(self, lo: int, hi: int, x, positions, enc_out=None):
        """Layers lo..hi-1 in the training phase: (x, summed aux), what
        remat checkpoints."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(lo, hi):
            x, _, a = self._layer(i)(x, self.cfg, positions, phase="train",
                                     enc_out=enc_out)
            aux = aux + a
        return x, aux

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _embed(self, tokens: torch.Tensor, offset: int,
               extras: Optional[dict] = None) -> torch.Tensor:
        """Token embeddings; a VLM's ``extras["patches"]`` (B, n_patches,
        d), cast to the embeddings' dtype and projected by
        ``vision_proj``, replace the first n_patches positions.  The lookup
        is ``F.embedding``, whose backward sums each row's gradient in a
        fixed order (``embed[tokens]``'s scatter-add does not on a CPU with
        several threads, and a training run then drifts from run to
        run)."""
        cfg = self.cfg
        x = self._lookup(tokens)
        if cfg.n_patches and extras is not None and "patches" in extras:
            patches = extras["patches"]
            b, s = tokens.shape
            if s < cfg.n_patches:
                raise ValueError(f"{cfg.name}: {s} positions cannot hold "
                                 f"the {cfg.n_patches} patches")
            if tuple(patches.shape) != (b, cfg.n_patches, cfg.d_model):
                raise ValueError(f"{cfg.name}: patches of shape "
                                 f"{tuple(patches.shape)}, expected "
                                 f"{(b, cfg.n_patches, cfg.d_model)}")
            x = torch.cat([self._project(patches.to(device=x.device,
                                                    dtype=x.dtype)),
                           x[:, cfg.n_patches:]], 1)
        if cfg.rope_theta == 0:   # sinusoidal absolute positions
            pos = torch.arange(tokens.shape[1], device=x.device) + offset
            x = x + layers.sinusoidal_positions(
                pos, cfg.d_model)[None].to(x.dtype)
        return x

    def _project(self, patches: torch.Tensor) -> torch.Tensor:
        """``patches @ vision_proj``; with its columns split over the model
        axis (``self.tp``), each rank's columns are gathered, so that every
        rank holds the whole projection (the patches enter that region
        through ``copy_to_model``, as ``_head``'s input does).  Its shards
        over the data axis, laid out for training, are gathered for the
        product."""
        if self.vision_proj.shape[1] == self.cfg.d_model:
            return collectives.matmul(self, "vision_proj", patches)
        patches = collectives.copy_to_model(patches, self.tp)
        return collectives.gather_last(
            collectives.matmul(self, "vision_proj", patches), self.tp)

    def _encode(self, extras: Optional[dict], phase: str):
        """The encoder over ``extras["frames"]`` (B, enc_frames, d): frames
        plus sinusoidal positions, the bidirectional blocks (window
        ``cfg.sliding_window``, as the JAX package's ``_encode`` passes
        it), then the model's ``final_norm``.  At ``"train"`` the plain
        attention under autograd, each block checkpointed under
        ``cfg.remat == "unit"``; at ``"prefill"`` the flash kernel, the
        blocks' caches dropped.  None for a decoder-only model."""
        cfg = self.cfg
        if not cfg.enc_layers:
            return None
        if extras is None or "frames" not in extras:
            raise ValueError(f"{cfg.name}: the encoder needs the audio "
                             f"frames, extras['frames'] (B, {cfg.enc_frames}, "
                             f"{cfg.d_model}); none were given")
        frames = extras["frames"].to(device=self.device,
                                     dtype=self.embed.dtype)
        x = frames + layers.sinusoidal_positions(
            torch.arange(frames.shape[1], device=self.device),
            cfg.d_model)[None].to(frames.dtype)
        positions = torch.zeros((1, 1), dtype=torch.int32, device=self.device)
        remat = phase == "train" and cfg.remat != "none"
        for blk in self.enc_blocks:
            if remat:
                x, _, _ = _remat(cfg.remat, blk, x, cfg, positions,
                                 phase=phase)
            else:
                x, _, _ = blk(x, cfg, positions, phase=phase)
        return rmsnorm(x, self.final_norm, cfg.norm_eps)

    def _lookup(self, tokens: torch.Tensor) -> torch.Tensor:
        """``F.embedding`` of the tokens; with the vocabulary sharded over
        the model axis (``self.tp``), each rank looks up the tokens its
        rows hold, zeros elsewhere, and the axis sums them (one rank holds
        each row, so the sum is exact).  The table's shards over the data
        axis, laid out for training, are gathered first."""
        embed = collectives.weight(self, "embed")
        if embed.shape[0] == self.cfg.vocab:
            return F.embedding(tokens, embed)
        rows = embed.shape[0]
        local = tokens - self.tp.party_index * rows
        mine = (local >= 0) & (local < rows)
        x = F.embedding(local.clamp(0, rows - 1), embed)
        return collectives.reduce_from_model(
            torch.where(mine[..., None], x, 0), self.tp)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        """The final norm and ``lm_head``'s logits of every position; a
        vocabulary-sharded ``lm_head``'s are gathered over the model axis,
        so every rank holds all of them."""
        x = rmsnorm(x, self.final_norm, self.cfg.norm_eps)
        if self.lm_head.shape[1] == self.cfg.vocab:
            return collectives.matmul(self, "lm_head", x)
        x = collectives.copy_to_model(x, self.tp)
        return collectives.gather_last(
            collectives.matmul(self, "lm_head", x), self.tp)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """Last-position logits."""
        return self._head(x)[:, 0]

    def forward_train(self, tokens: torch.Tensor,
                      extras: Optional[dict] = None):
        """(B, S) tokens -> ((B, S, V) logits, aux loss), differentiable
        in the weights once they require grad (``self.requires_grad_()``;
        the training step does it).  ``extras`` holds the modality stubs
        (``frames``, ``patches``); a configuration ignores those it has no
        use for.

        Attention runs the training phase (the plain ``_sdpa_chunked``,
        never the flash kernel); the MoE aux losses of all layers are
        summed (float32).  ``cfg.remat``, as the JAX package's
        ``_run_stack``: ``"unit"`` checkpoints each pattern unit (its
        activations are recomputed in the backward pass; the tail blocks
        are not checkpointed) and each encoder block, ``"dots"`` and
        ``"attn_out"`` checkpoint the same spans but keep what their
        policy saves (:data:`REMAT_SAVES`), ``"none"`` keeps everything.

        A model sharded for training (``parallel.shard_model(...,
        mode="train")``) runs its share with the collectives of
        ``models/collectives.py``; one sharded for serving raises."""
        cfg = self.cfg
        if cfg.remat not in (*REMAT_SAVES, "none"):
            raise ValueError(f"unknown remat {cfg.remat!r}")
        if self.tp is not None and self.layout is None:
            raise NotImplementedError(
                f"{cfg.name}: a model sharded for serving (mode='serve': "
                f"no optimizer state, weights whole over the data axis) "
                f"does not train; shard it with mode='train'")
        b, s = tokens.shape
        enc_out = self._encode(extras, "train")
        x = self._embed(tokens, 0, extras)
        positions = _positions_for(cfg, b, s, 0, x.device)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        n_pat = len(cfg.pattern)
        spans = [(u * n_pat, (u + 1) * n_pat, cfg.remat != "none")
                 for u in range(cfg.n_units)]
        spans += [(i, i + 1, False)
                  for i in range(cfg.n_units * n_pat, cfg.n_layers)]
        for lo, hi, remat in spans:
            if remat:
                x, a = _remat(cfg.remat, self._train_layers, lo, hi, x,
                              positions, enc_out)
            else:
                x, a = self._train_layers(lo, hi, x, positions, enc_out)
            aux = aux + a
        return self._head(x), aux

    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor, cache_len: Optional[int] = None,
                extras: Optional[dict] = None):
        """(B, S) tokens and the modality stubs ``extras`` -> (last-position
        logits (B, V), cache).  The cache is a list with one entry per
        layer: a ring buffer {k, v, kpos} of capacity ``cache_len`` (default
        S; at most the sliding window) for an attention layer (each use of
        a shared block has its own) — {"self": ring, "cross": {k, v}} with
        cross-attention, the encoder states' projections — the recurrent
        state after the S tokens for an SSM layer
        (:mod:`repro_torch.models.ssm`).  The encoder's attention, like the
        decoder's, goes through the flash kernel (the JAX package runs its
        plain attention there: the same function)."""
        b, s = tokens.shape
        enc_out = self._encode(extras, "prefill")
        x = self._embed(tokens, 0, extras)
        positions = _positions_for(self.cfg, b, s, 0, x.device)
        cache = []
        for i in range(len(self.blocks)):
            x, c, _ = self._layer(i)(x, self.cfg, positions, phase="prefill",
                                     cache_len=cache_len, enc_out=enc_out)
            cache.append(c)
        return self._logits(x[:, -1:]), cache

    @torch.inference_mode()
    def decode_step(self, cache: list, token: torch.Tensor, pos: int):
        """One token (B, 1) at absolute position ``pos`` against the cache
        -> (logits (B, V), cache).  The cache list is updated in place: an
        attention layer's ring buffer is written in place, an SSM layer's
        entry is replaced by its new state; a cross-attention cache is read
        only.  No patches are embedded."""
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


def draw_params(cfg: ArchConfig, gen: torch.Generator, device):
    """Every weight of the model in the order the generator draws it:
    (parameter name, float32 value) pairs, each value drawn only when the
    iteration reaches it, so a caller can keep a slice of each leaf and
    free the rest before the next (``models/parallel.py::shard_model``).
    The JAX package's initial scales: embed N(0, 1)·0.02, lm_head and
    vision_proj N(0, 1)/sqrt(d), every projection N(0, 1)/sqrt(fan_in)
    (the MoE's as ``layers.moe_draws``, the recurrent cores' as
    ``ssm.INITS``), norm scales 1."""
    d = cfg.d_model

    def ones():
        return torch.ones((d,), device=device)
    yield "embed", torch.randn((cfg.vocab, d), generator=gen,
                               device=device) * 0.02
    yield "final_norm", ones()
    yield "lm_head", torch.randn((d, cfg.vocab), generator=gen,
                                 device=device) / math.sqrt(d)
    kinds = layer_kinds(cfg)
    blocks = [(f"blocks.{i}", False) for i, kind in enumerate(kinds)
              if kind == "attn"]
    if "attn_shared" in kinds:
        blocks.append(("shared_attn", False))
    blocks += [(f"enc_blocks.{j}", True) for j in range(cfg.enc_layers)]
    for prefix, bidir in blocks:
        yield f"{prefix}.ln1", ones()
        yield f"{prefix}.ln2", ones()
        for name, value in layers.attention_draws(gen, cfg, device):
            yield f"{prefix}.attn.{name}", value
        ffn = (layers.moe_draws(gen, cfg, device)
               if cfg.n_experts and not bidir
               else layers.mlp_draws(gen, cfg, device))
        for name, value in ffn:
            yield f"{prefix}.ffn.{name}", value
        if cfg.cross_attention and not bidir:
            yield f"{prefix}.ln_cross", ones()
            for name, value in layers.attention_draws(gen, cfg, device):
                yield f"{prefix}.cross.{name}", value
    if cfg.n_patches:
        yield "vision_proj", torch.randn((d, d), generator=gen,
                                         device=device) / math.sqrt(d)
    for i, kind in enumerate(kinds):
        if kind in ssm.INITS:
            yield f"blocks.{i}.ln", ones()
            core = ssm.INITS[kind](gen, cfg, device)
            for name, value in core.named_parameters():
                yield f"blocks.{i}.core.{name}", value


@torch.no_grad()
def init_params(cfg: ArchConfig, seed: int = 0, device=None) -> Transformer:
    """A :class:`Transformer` with the JAX package's initial scales and
    dtypes (:func:`draw_params`), drawn from a ``torch.Generator`` seeded
    with ``seed`` on the model's device.  (The two frameworks draw
    different numbers from one seed.)"""
    model = Transformer(cfg, device)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    for name, value in draw_params(cfg, gen, model.device):
        model.get_parameter(name).copy_(value)
    return model


def lm_loss(model: Transformer, batch: dict):
    """Next-token cross-entropy over ``batch["tokens"]`` plus 0.01·aux, as
    the JAX package's ``lm_loss``: the batch's other keys go to
    ``forward_train`` as the extras (a configuration ignores those it has
    no use for), labels are the tokens shifted left and padded with 0, the
    last position masked out, the log-sum-exp taken in float32.  Returns
    (loss, (ce, aux))."""
    tokens = batch["tokens"]
    logits, aux = model.forward_train(
        tokens, extras={k: v for k, v in batch.items() if k != "tokens"})
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
    too; with cross-attention {"self": ring, "cross": zeros of (B,
    enc_frames, Kh, dh) k and v}), a zero state for an SSM block."""
    dev = resolve_device(device)
    cap = seq_len if cfg.sliding_window is None else min(cfg.sliding_window,
                                                         seq_len)

    def attn_cache():
        ring = layers.init_attn_cache(cfg, batch, cap, dev)
        if not cfg.cross_attention:
            return ring
        return {"self": ring,
                "cross": layers.init_cross_cache(cfg, batch, dev)}
    return [attn_cache() if kind in ("attn", "attn_shared")
            else ssm.CACHES[kind](cfg, batch, dev)
            for kind in layer_kinds(cfg)]
