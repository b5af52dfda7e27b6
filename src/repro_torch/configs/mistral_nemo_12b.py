"""mistral-nemo-12b [dense] — 128k ctx [hf:mistralai/Mistral-Nemo-Base-2407].

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072, head_dim=128.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mistral-nemo-12b",
    arch_type="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab=131072,
    rope_theta=1e6,
)
