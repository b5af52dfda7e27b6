"""Synthetic language-modeling tokens.

Markov-chain token streams with learnable structure, made with NumPy so
that a seed gives the JAX package's tokens bit for bit.  Deterministic per
seed; an infinite generator, the shape a real pipeline would have.  The
modality stubs of the audio and VLM families (frames, patches) are not
ported: the port's model runs the dense family only.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device


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


def synthetic_lm_batches(cfg: ArchConfig, batch: int, seq: int, *,
                         seed: int = 0, device: torch.device | str | None = None
                         ) -> Iterator[dict]:
    """Endless ``{"tokens": (batch, seq) int64}`` batches on ``device``
    (``None``: the CUDA card)."""
    dev = resolve_device(device)
    if cfg.enc_layers or cfg.n_patches:
        raise NotImplementedError(
            f"{cfg.name}: audio frames and vision patches are not ported")
    rng = np.random.default_rng(seed)
    while True:
        yield {"tokens": torch.as_tensor(
            _markov_tokens(rng, cfg.vocab, (batch, seq)),
            dtype=torch.int64, device=dev)}
