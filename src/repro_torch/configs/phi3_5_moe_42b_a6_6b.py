"""phi3.5-moe-42b-a6.6b [moe] — 16 experts top-2
[hf:microsoft/Phi-3.5-MoE-instruct].

32L d_model=4096 32H (GQA kv=8) d_ff=6400 vocab=32064, MoE 16e top-2.
16 experts shard exactly over the 16-way model axis (1 expert per shard) —
the expert-parallel all-to-all is the closest neural analogue of the paper's
vertical owner-computes pattern (DESIGN.md §5).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    arch_type="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=6400,
    vocab=32064,
    n_experts=16,
    top_k=2,
    d_expert=6400,
    rope_theta=1e6,
)
