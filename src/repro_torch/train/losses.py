"""Loss functions (fp32 accumulation) — the port of
``repro/train/losses.py``."""
from __future__ import annotations

import torch

from repro_torch.core import tp


def cross_entropy(logits, labels, *, ignore_id: int = -1):
    """logits (B,S,V), labels (B,S) int. Mean over non-ignored tokens —
    of the global batch where the step in flight runs on this rank's
    rows of a batch split over the data-parallel axis ("pod" x "data"):
    the count of valid tokens summed over it (``"loss_tokens"``), so the
    data ranks' losses sum to the reference's."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1,
                      labels.clamp(min=0).long()[..., None])[..., 0]
    nll = lse - ll
    mask = (labels != ignore_id).float()
    count = mask.sum()
    if tp.data_rows() is not None:
        count = tp.axis_sum(count.clone(), tp.BATCH, "loss_tokens")
    return (nll * mask).sum() / torch.clamp(count, min=1.0)


def token_accuracy(logits, labels, *, ignore_id: int = -1):
    pred = torch.argmax(logits, dim=-1)
    mask = labels != ignore_id
    hits = torch.where(mask, pred == labels, torch.zeros_like(mask))
    return hits.sum() / torch.clamp(mask.sum(), min=1)
