"""Core layers of the dense decoder — the port of ``repro/models/layers.py``
(norms, RoPE, GQA attention, attention projections, SwiGLU MLP).

Layouts are the JAX package's: activations ``(B, S, d)``, heads
``(B, S, H, D)``, weights ``(in, out)`` applied as ``x @ w``. The
sharding hints (``constrain``) of the reference have no counterpart on a
single card and are gone. The two ops that were Pallas kernels on the TPU
— paged attention and the fused MLP — dispatch by device to the port's
CUDA kernels (CUDA tensors) or their plain versions (CPU tensors).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.fused_mlp import fused_mlp
# decode-time block-table attention over the paged pool, q (B, 1, Hq, D):
# the hand-written kernel on CUDA tensors, the gather + masked-softmax
# plain version on CPU tensors
from repro_torch.kernels.paged_attention import (  # noqa: F401
    NEG_INF, paged_attention)


# --------------------------------------------------------------------- norms

def rmsnorm(x, scale, eps: float = 1e-5):
    """fp32 math with an fp32 ``scale``, cast back to x's dtype."""
    x32 = x.float()
    inv = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (x32 * inv * scale).to(x.dtype)


# ---------------------------------------------------------------------- RoPE

def rope_freqs(head_dim: int, theta: float):
    """Inverse frequencies in float64 numpy, as the reference computes
    them before casting to float32."""
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


def apply_rope(x, positions, theta: float):
    """Half-split (not interleaved) rotation. x: (..., S, H, D);
    positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    freqs = torch.from_numpy(rope_freqs(d, theta)).to(
        device=x.device, dtype=torch.float32)                 # (D/2,)
    ang = positions[..., :, None].float() * freqs               # (..., S, D/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------- attention

def attention_full(q, k, v, *, causal: bool, window: int = 0,
                   q_offset=0, kv_len=None, kpos=None):
    """Materialised-scores attention. q:(B,S,Hq,D) k,v:(B,T,Hkv,D) ->
    (B,S,Hq,D).

    q_offset: absolute position of q[:, 0]; scalar or per-row (B,).
    kv_len: optional valid KV length; scalar or per-row (B,).
    kpos: optional absolute position per KV slot, (T,) or (B, T);
    entries < 0 are masked out. The probs are cast to q's dtype before
    P·V, as the reference does.
    """
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    dev = q.device
    k = k.repeat_interleave(hq // hkv, dim=2)
    v = v.repeat_interleave(hq // hkv, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float())
    scores = scores * (1.0 / np.sqrt(d))
    qpos = torch.as_tensor(q_offset, device=dev).reshape(-1, 1) \
        + torch.arange(s, device=dev)                          # (1|B, S)
    kpos = torch.arange(t, device=dev) if kpos is None \
        else torch.as_tensor(kpos, device=dev)
    kpos = kpos[None, :] if kpos.ndim == 1 else kpos           # (1|B, T)
    mask = torch.ones((1, s, t), dtype=torch.bool, device=dev)
    if causal:
        mask = mask & (kpos[:, None, :] <= qpos[:, :, None])
    if window > 0:
        mask = mask & (kpos[:, None, :] > qpos[:, :, None] - window)
    if kv_len is not None:
        kv_len = torch.as_tensor(kv_len, device=dev).reshape(-1, 1, 1)
        mask = mask & (kpos[:, None, :] < kv_len)
    mask = mask & (kpos[:, None, :] >= 0)
    scores = scores.masked_fill(~mask[:, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhst,bthd->bshd", probs.float(), v.float())
    return out.to(q.dtype)


# ------------------------------------------------------- attention (module)

def attn_qkv(p, x, cfg, *, positions=None, rope: bool = True):
    """Project to q,k,v (+qk_norm, +rope). x:(B,S,d) -> q(B,S,Hq,D), k/v."""
    b, s, _ = x.shape
    q = (x @ p["wq"]).reshape(b, s, cfg.num_heads, cfg.head_dim)
    k = (x @ p["wk"]).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = (x @ p["wv"]).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if rope:
        if positions is None:
            positions = torch.arange(s, device=x.device)[None, :]
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_out(p, ctx, cfg):
    b, s = ctx.shape[:2]
    return ctx.reshape(b, s, cfg.q_dim) @ p["wo"]


# ----------------------------------------------------------------------- MLP

def mlp(p, x):
    """Gated (SwiGLU) MLP — the survey's §5.1 block — through the fused
    kernel pair on CUDA tensors, its plain version on CPU tensors. The
    reference's plain-GeLU variant (no ``w_gate``) serves the enc-dec
    family, which waits for a later slice."""
    if "w_gate" not in p:
        raise NotImplementedError(
            "plain-GeLU MLP (enc-dec family): ROADMAP.md Queue 1 item 10")
    return fused_mlp(x, p["w_gate"], p["w_up"], p["w_down"])
