"""glm4-9b [dense] — RoPE, extreme GQA (kv=2) [hf:THUDM/glm-4-9b].

40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="glm4-9b",
    arch_type="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab=151552,
    rope_theta=1e6,
)
