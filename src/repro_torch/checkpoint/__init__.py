"""Checkpoints in the JAX package's npz + manifest layout."""
from repro_torch.checkpoint.io import (  # noqa: F401
    latest_step, load_checkpoint, save_checkpoint)
