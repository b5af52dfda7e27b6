"""Architecture config system (the port's own copy of the JAX package's).

One frozen dataclass describes every supported architecture family: dense
(GQA/RoPE/qk-norm), MoE (routed + shared experts), SSM (Mamba2 / xLSTM),
hybrid (Mamba2 + shared attention), encoder-decoder audio (whisper) and VLM
(M-RoPE + patch-embedding stub).  The port's model runs every family
(``repro_torch.models.transformer.check_supported``).

Layers are grouped into a repeating ``pattern`` of block kinds; the JAX
package scans over stacked pattern-units, the port loops over layers.
Fields, derived properties and ``param_count`` are the JAX package's, field
for field, so a configuration means the same thing in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

BLOCK_KINDS = ("attn", "attn_shared", "mamba2", "mlstm", "slstm")


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str                     # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0                    # 0 -> d_model // n_heads
    pattern: tuple[str, ...] = ("attn",)
    qk_norm: bool = False
    rope_theta: float = 1e6
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0          # qwen2-moe: shared-expert ffn = n*d_expert
    d_expert: int = 0                  # routed expert ffn width (0 -> d_ff)
    moe_capacity: float = 1.25
    # --- SSM (mamba2 / xlstm) ---
    ssm_state: int = 0
    ssm_heads: int = 0                 # 0 -> derived from d_inner / 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256
    # --- encoder-decoder (audio) ---
    enc_layers: int = 0
    enc_frames: int = 0                # stub frontend positions (whisper: 1500)
    cross_attention: bool = False
    # --- vlm ---
    mrope_sections: Optional[tuple[int, int, int]] = None
    n_patches: int = 0                 # stub vision tokens prepended
    # --- serving / variants ---
    sliding_window: Optional[int] = None   # set by the long_500k SWA variant
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    # activation rematerialization for the unit scan:
    #   "none" | "unit" (checkpoint whole unit) | "dots" (save matmul outputs)
    remat: str = "unit"
    # --- §Perf hillclimb levers (baseline = False) ---
    attn_probs_bf16: bool = False   # cast softmax probs to bf16 before P@V
    attn_scores_bf16: bool = False  # materialize S×S scores in bf16 too
    moe_shard_acts: bool = False    # sharding constraints on MoE dispatch acts
    pad_experts: bool = False       # pad E to a multiple of 16 dead experts
                                    # (router never routes to them) so the
                                    # expert dim shards cleanly

    # ------------------------------------------------------------- derived
    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.ssm_heads or max(1, self.d_inner // 64)

    @property
    def ssm_head_dim(self) -> int:
        return self.d_inner // self.n_ssm_heads

    @property
    def n_units(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def tail_blocks(self) -> tuple[str, ...]:
        """Blocks left over after scanning n_units full patterns."""
        return self.pattern[: self.n_layers % len(self.pattern)]

    @property
    def has_attention(self) -> bool:
        return (any(b.startswith("attn") for b in self.pattern)
                or self.cross_attention or self.enc_layers > 0)

    @property
    def is_subquadratic(self) -> bool:
        """Eligible for long_500k natively (recurrent-state blocks only)."""
        return all(b in ("mamba2", "mlstm", "slstm") for b in self.pattern)

    def with_(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    # --------------------------------------------------------- param count
    def param_count(self) -> int:
        """Approximate N for MODEL_FLOPS = 6·N·D bookkeeping."""
        d, dh = self.d_model, self.head_dim
        per: dict[str, int] = {}
        attn = d * dh * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * dh * d
        dense_mlp = 3 * d * self.d_ff
        per["attn"] = attn + (dense_mlp if self.n_experts == 0 else self._moe_params())
        per["attn_shared"] = 0  # shared weights counted once below
        di, n = self.d_inner, self.ssm_state
        per["mamba2"] = d * (2 * di + 2 * n * self.n_ssm_heads + self.n_ssm_heads) + di * d + self.ssm_conv * di
        per["mlstm"] = d * 2 * di + 3 * di * di // max(1, self.n_ssm_heads) + di * d
        per["slstm"] = 4 * d * di + 4 * di * self.ssm_head_dim + di * d + 3 * di * d
        total = sum(per.get(b, 0) for b in self.pattern) * self.n_units
        total += sum(per.get(b, 0) for b in self.tail_blocks)
        if "attn_shared" in self.pattern:
            total += attn + dense_mlp
        total += 2 * self.vocab * d                      # embed + lm head
        if self.enc_layers:
            total += self.enc_layers * (attn + dense_mlp)
        return total

    def _moe_params(self) -> int:
        d = self.d_model
        fe = self.d_expert or self.d_ff
        routed = self.n_experts * 3 * d * fe
        shared = self.n_shared_experts * 3 * d * fe
        return routed + shared + d * self.n_experts

    def active_param_count(self) -> int:
        """N_active for MoE MODEL_FLOPS."""
        if self.n_experts == 0:
            return self.param_count()
        d = self.d_model
        fe = self.d_expert or self.d_ff
        inactive = (self.n_experts - self.top_k) * 3 * d * fe
        return self.param_count() - inactive * self.n_units


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Smoke-test variant: <=2 pattern units, d_model<=256, <=4 experts."""
    pat = cfg.pattern
    return cfg.with_(
        n_layers=max(len(pat), 2 if len(pat) == 1 else len(pat)),
        d_model=256, n_heads=4, n_kv_heads=2, d_head=64,
        d_ff=512 if cfg.d_ff else 0, vocab=512,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        # no-drop capacity so decode == full forward in consistency tests
        # (capacity dropping is a train/serve discrepancy inherent to the
        # routing algorithm, not a cache bug)
        moe_capacity=8.0,
        n_shared_experts=min(cfg.n_shared_experts, 1),
        d_expert=128 if cfg.d_expert else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_heads=0, ssm_chunk=32,
        enc_layers=min(cfg.enc_layers, 2),
        enc_frames=min(cfg.enc_frames, 16),
        n_patches=min(cfg.n_patches, 8),
        mrope_sections=(8, 12, 12) if cfg.mrope_sections else None,
        dtype="float32",
    )
