"""xlstm-350m [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517].

24L d_model=1024 4H (GQA kv=4) d_ff=0 vocab=50304.  d_ff=0: xLSTM blocks
carry their own up-projection (expand=2) instead of a separate MLP.  Blocks
alternate mLSTM (matrix memory, parallelizable) and sLSTM (scalar memory,
true recurrence), per the paper's mixed-stack configuration.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-350m",
    arch_type="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    pattern=("mlstm", "slstm"),
    ssm_state=64,      # mLSTM key/value head state width
    ssm_heads=4,
    ssm_expand=2,
)
