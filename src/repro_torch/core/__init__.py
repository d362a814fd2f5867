"""The port's execution knobs (``Strategy``)."""
from repro_torch.core.strategy import Strategy  # noqa: F401
