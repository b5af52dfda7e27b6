"""qwen2-vl-2b [vlm] — M-RoPE, dynamic resolution [arXiv:2409.12191].

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.  The ViT tower +
projector is a stub per the assignment carve-out: ``input_specs`` supplies
patch embeddings (B, n_patches, d_model) which replace the first n_patches
token positions.  M-RoPE splits each rotary half-dim into (t, h, w)
sections (16/24/24 of head_dim/2 = 64); text tokens advance t only, vision
patches advance h/w on a grid.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-2b",
    arch_type="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_head=128,
    d_ff=8960,
    vocab=151936,
    mrope_sections=(16, 24, 24),
    n_patches=256,
    rope_theta=1e6,
)
