"""LM training: AdamW and its schedule (``optim``), the microbatched
training step (``step``)."""
from repro_torch.train.optim import (adamw_init, adamw_update,  # noqa: F401
                                     cosine_lr)
from repro_torch.train.step import make_train_step  # noqa: F401
