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


def ssd_scan_ref(x, dt, A, B, C, *, chunk: int = 0):
    """Sequential (non-chunked) SSD recurrence — the ground truth.

    x (b,s,h,p), dt (b,s,h), A (h,), B/C (b,s,n). Returns y (b,s,h,p) in
    x's dtype; the state is fp32."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        dtt = dt[:, t].float()                              # (b,h)
        a = torch.exp(dtt * A.float()[None])
        upd = torch.einsum("bh,bn,bhp->bhpn", dtt, B[:, t].float(),
                           x[:, t].float())
        state = a[:, :, None, None] * state + upd
        ys.append(torch.einsum("bn,bhpn->bhp", C[:, t].float(), state))
    return torch.stack(ys, dim=1).to(x.dtype)
