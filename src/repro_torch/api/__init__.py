"""The port's public API: :class:`Session`."""
from repro_torch.api.session import Session  # noqa: F401
