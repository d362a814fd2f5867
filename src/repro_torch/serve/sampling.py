"""Sampling shared by the port's serve engine — the port of
``repro/serve/sampling.py``.

``temperature <= 0`` (or no generator) is exact greedy argmax, the first
maximum winning as in the reference; otherwise temperature-scaled
categorical sampling drawn from the caller's ``torch.Generator``. The
draws are the port's own: they cannot replay ``jax.random``'s stream.
"""
from __future__ import annotations

from typing import Optional

import torch


def sample_tokens(logits, *, generator: Optional[torch.Generator] = None,
                  temperature: float = 0.0):
    """logits (..., V) -> sampled token ids (...,) int32."""
    if temperature <= 0.0 or generator is None:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    tok = torch.multinomial(flat, 1, generator=generator)
    return tok.reshape(probs.shape[:-1]).to(torch.int32)
