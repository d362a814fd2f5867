"""Plain PyTorch oracles of the TPU kernels — the port of
``repro/kernels/ref.py`` (the allclose targets)."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def causal_window_mask(s: int, t: int, *, causal: bool, window: int,
                       device=None):
    """(S, T) bool: True where query ``i`` may attend key ``j``."""
    qpos = torch.arange(s, device=device)[:, None]
    kpos = torch.arange(t, device=device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window > 0:
        mask = mask & (kpos > qpos - window)
    return mask


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q (B,S,H,D), k/v (B,T,H,D) — MHA (callers pre-repeat GQA heads).
    fp32 scores and softmax, masked entries at -1e30, output in q's
    dtype."""
    s, d = q.shape[1], q.shape[3]
    t = k.shape[1]
    scores = torch.einsum("bshd,bthd->bhst", q.float(),
                          k.float()) / math.sqrt(d)
    mask = causal_window_mask(s, t, causal=causal, window=window,
                              device=q.device)
    scores = scores.masked_fill(~mask, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhst,bthd->bshd", p, v.float()).to(q.dtype)
