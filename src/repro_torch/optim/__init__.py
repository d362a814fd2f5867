"""Optimizers written by hand on tensors (``optim/optimizers.py``)."""
from repro_torch.optim.optimizers import (  # noqa: F401
    adafactor_init, adafactor_update, adamw_init, adamw_update,
    clip_by_global_norm, cosine_lr, get_optimizer)
