"""whisper-large-v3 [audio] — encoder-decoder, conv frontend STUB
[arXiv:2212.04356].

32L d_model=1280 20H (kv=20) d_ff=5120 vocab=51866. The mel-spectrogram +
conv feature extractor is a stub per the assignment carve-out:
``input_specs`` supplies precomputed frame embeddings (B, 1500, 1280); the
implemented system is the 32L bidirectional encoder + 32L decoder with
causal self-attention and cross-attention.  No RoPE (learned positions).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3",
    arch_type="audio",
    n_layers=32,            # decoder layers
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab=51866,
    rope_theta=0.0,         # 0 -> learned absolute positions
    enc_layers=32,
    enc_frames=1500,
    cross_attention=True,
)
