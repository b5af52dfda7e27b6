"""Synthetic language-modeling tokens.

Markov-chain token streams with learnable structure, made with NumPy so
that a seed gives the JAX package's tokens bit for bit, and the modality
stubs (frames, patches) that the audio and VLM families consume, bit for
bit too.  Deterministic per seed; an infinite generator, the shape a real
pipeline would have.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.layers import torch_dtype


def _markov_tokens(rng: np.random.Generator, vocab: int, shape,
                   order_states: int = 64) -> np.ndarray:
    """Tokens from a sparse random Markov chain over `order_states` states."""
    trans = rng.integers(0, vocab, size=(order_states, 8))
    state = rng.integers(0, order_states, size=shape[0])
    out = np.empty(shape, np.int32)
    for t in range(shape[1]):
        choice = rng.integers(0, 8, size=shape[0])
        out[:, t] = trans[state, choice]
        state = (out[:, t] + choice) % order_states
    return out


def _stub(rng: np.random.Generator, shape, dtype: torch.dtype,
          device) -> torch.Tensor:
    """N(0, 1)·0.1 drawn in float64 and cast as the JAX package casts it:
    ``jnp.asarray(a, bfloat16)`` with 64-bit types off rounds the float64
    to float32 first, then to ``dtype`` (two roundings, which a direct
    cast could differ from), so the port takes the same route."""
    a = (rng.normal(size=shape) * 0.1).astype(np.float32)
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def stubs(cfg: ArchConfig, rng: np.random.Generator, batch: int,
          dtype: torch.dtype = torch.float32, device="cpu") -> dict:
    """The modality stubs ``cfg`` takes, drawn from ``rng`` in the JAX
    package's order (:func:`_stub`): ``"frames"`` (batch, enc_frames,
    d_model) for an encoder-decoder, ``"patches"`` (batch, n_patches,
    d_model) for a VLM; {} for a decoder-only model."""
    out = {}
    if cfg.enc_layers:
        out["frames"] = _stub(rng, (batch, cfg.enc_frames, cfg.d_model),
                              dtype, device)
    if cfg.n_patches:
        out["patches"] = _stub(rng, (batch, cfg.n_patches, cfg.d_model),
                               dtype, device)
    return out


def synthetic_lm_batches(cfg: ArchConfig, batch: int, seq: int, *,
                         seed: int = 0, device: torch.device | str | None = None
                         ) -> Iterator[dict]:
    """Endless batches on ``device`` (``None``: the CUDA card):
    ``{"tokens": (batch, seq) int64}``, with ``"frames"`` (batch,
    enc_frames, d_model) for an encoder-decoder and ``"patches"`` (batch,
    n_patches, d_model) for a VLM, in ``cfg.dtype``, drawn after the
    tokens in the JAX package's order."""
    dev = resolve_device(device)
    dt = torch_dtype(cfg)
    rng = np.random.default_rng(seed)
    while True:
        b = {"tokens": torch.as_tensor(
            _markov_tokens(rng, cfg.vocab, (batch, seq)),
            dtype=torch.int64, device=dev)}
        yield {**b, **stubs(cfg, rng, batch, dt, dev)}
