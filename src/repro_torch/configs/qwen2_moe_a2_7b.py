"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed experts top-4
[hf:Qwen/Qwen1.5-MoE-A2.7B].

24L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=151936, MoE 60e top-4.
d_ff=1408 is the routed-expert width; the shared expert is 4×1408=5632 wide
(n_shared_experts=4).  60 routed experts don't divide the 16-way model axis;
the sharding rule pads the expert dim to 64 slots (4 per shard) — see
models/sharding.py.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    arch_type="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=151936,
    n_experts=60,
    top_k=4,
    n_shared_experts=4,
    d_expert=1408,
    rope_theta=1e6,
)
