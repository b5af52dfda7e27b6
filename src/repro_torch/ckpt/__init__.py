"""Checkpoints in the JAX package's on-disk format (no JAX, no msgpack)."""
from repro_torch.ckpt.checkpoint import (latest_step,  # noqa: F401
                                         peek_checkpoint, read_meta,
                                         restore_checkpoint, save_checkpoint)
