"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention blocks
[arXiv:2411.15242].

81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000, ssm_state=64.
Zamba2 interleaves a SHARED (weight-tied) attention+MLP block into the
Mamba2 stack; we use a 6-block repeating unit (5×mamba2 + 1×attn_shared),
81 = 13 units + 3 tail mamba2 blocks.  The shared block's weights live
outside the scan and are reused by every unit — the defining Zamba trick.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    arch_type="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab=32000,
    pattern=("mamba2", "mamba2", "mamba2", "mamba2", "mamba2", "attn_shared"),
    ssm_state=64,
    ssm_expand=2,
)
