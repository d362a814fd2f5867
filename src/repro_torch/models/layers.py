"""Core layers of the dense decoder — the port of ``repro/models/layers.py``
(norms, RoPE, GQA attention, attention projections, SwiGLU and plain-GeLU
MLPs).

Layouts are the JAX package's: activations ``(B, S, d)``, heads
``(B, S, H, D)``, weights ``(in, out)`` applied as ``x @ w``. The
reference's sharding hints (``constrain``) have no counterpart: under a
tensor-parallel mesh each rank runs these layers on its own shards
(``core/tp.py``) — the head counts follow the local weights, and the
row-parallel attention out and MLP end in ``tp.all_reduce`` (the
reduce-scatter under sequence parallelism), a no-op unsharded. The ops
that were Pallas kernels on the TPU — flash attention, paged attention
and the fused MLP — dispatch by device
to the port's CUDA kernels (CUDA tensors) or their plain versions (CPU
tensors). The fused MLP has no backward, so with a gradient required the
MLP is the reference's plain matmul SwiGLU on either device; the
plain-GeLU MLP never runs a kernel.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import tp
from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.fused_mlp import fused_mlp, needs_grad
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


def _repeat_kv(x, rep: int):
    return x if rep == 1 else x.repeat_interleave(rep, dim=2)


def _attn_block(q, k, v, qpos, kpos, scale, causal, window, m, l, acc):
    """One (q-chunk, kv-chunk) online-softmax update. fp32 carries."""
    s = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    mask = torch.ones((q.shape[1], k.shape[1]), dtype=torch.bool,
                      device=q.device)
    if causal:
        mask = mask & (kpos[None, :] <= qpos[:, None])
    if window > 0:
        mask = mask & (kpos[None, :] > qpos[:, None] - window)
    s = s.masked_fill(~mask, NEG_INF)
    m_new = torch.maximum(m, s.amax(-1))                 # (B,H,Sq)
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(-1)
    acc_new = acc * corr[..., None] + torch.einsum(
        "bhst,bthd->bhsd", p, v.float())
    return m_new, l_new, acc_new


def attention_chunked(q, k, v, *, causal: bool, window: int = 0,
                      q_chunk: int = 1024, kv_chunk: int = 1024,
                      impl: str = "masked"):
    """Double-blocked flash-style attention in plain PyTorch (the
    reference's pure-XLA form; Python loops where it maps and scans).

    impl="masked":   every (qi, ki) block pair is computed, causally-dead
                     blocks masked out.
    impl="triangle": only lower-triangle block pairs are computed.
    For window>0 each q chunk visits one KV slice of length
    window+q_chunk (rounded up to kv_chunk) => sub-quadratic.
    """
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    k, v = _repeat_kv(k, hq // hkv), _repeat_kv(v, hq // hkv)
    q_chunk, kv_chunk = min(q_chunk, s), min(kv_chunk, t)
    if s % q_chunk or t % kv_chunk:
        raise ValueError(f"attention_chunked: S={s}, T={t} must divide "
                         f"into q_chunk={q_chunk}, kv_chunk={kv_chunk}")
    nq, nk = s // q_chunk, t // kv_chunk
    scale = 1.0 / np.sqrt(d)
    dev = q.device

    def state():
        return (torch.full((b, hq, q_chunk), NEG_INF, device=dev),
                torch.zeros((b, hq, q_chunk), device=dev),
                torch.zeros((b, hq, q_chunk, d), device=dev))

    def span(i, n, start=0):
        return torch.arange(n, device=dev) + start + i * n

    outs = []
    for qi in range(nq):
        qc = q[:, qi * q_chunk:(qi + 1) * q_chunk]
        qpos = span(qi, q_chunk)
        m, l, acc = state()
        if window > 0:
            # one KV window per q chunk: [start, start + wlen)
            wlen = min(t, ((window + q_chunk + kv_chunk - 1) // kv_chunk)
                       * kv_chunk)
            start = min(max(qi * q_chunk + q_chunk - wlen, 0), t - wlen)
            m, l, acc = _attn_block(
                qc, k[:, start:start + wlen], v[:, start:start + wlen],
                qpos, span(0, wlen, start), scale, causal, window, m, l, acc)
            outs.append(acc / l[..., None])
            continue
        triangle = impl == "triangle" and causal and nq == nk
        for ki in range(qi + 1 if triangle else nk):
            kv = slice(ki * kv_chunk, (ki + 1) * kv_chunk)
            m, l, acc = _attn_block(qc, k[:, kv], v[:, kv], qpos,
                                    span(ki, kv_chunk), scale, causal,
                                    window, m, l, acc)
        if triangle:
            outs.append(acc / l[..., None])
        else:
            safe_l = torch.where(l == 0, torch.ones_like(l), l)
            outs.append(acc / safe_l[..., None])
    out = torch.cat(outs, dim=2)                         # (B,H,S,D)
    return out.transpose(1, 2).to(q.dtype)


def attention(q, k, v, *, causal: bool, window: int = 0, q_offset=0,
              kv_len=None, kpos=None, impl: str = "auto",
              q_chunk: int = 1024, kv_chunk: int = 1024):
    """Dispatching entry point used by all models: the reference's names
    and its ``auto`` rule on the CPU. On a CUDA tensor (or a meta one
    standing in for it, ``kernels/dispatch.py``) ``auto`` and
    ``pallas`` over a full sequence (S > 1, no ``kv_len``/``kpos``, and
    for ``auto`` no ``q_offset``) run the flash kernel; ``full``,
    ``masked``/``chunked`` and ``triangle`` stay available by name."""
    s, t = q.shape[1], k.shape[1]
    full_seq = s > 1 and kv_len is None and kpos is None
    if dispatch.on_card(q) and full_seq and (impl == "pallas" or (
            impl == "auto" and isinstance(q_offset, int) and q_offset == 0)):
        return flash_attention(q, k, v, causal=causal, window=window)
    if impl == "triangle" and (not causal or s != t or s % q_chunk):
        impl = "auto"            # triangle needs a square causal grid
    if impl == "auto":
        impl = "full" if (s * t <= 2048 * 2048 or s == 1) else "chunked"
    if impl == "full" or not full_seq:
        return attention_full(q, k, v, causal=causal, window=window,
                              q_offset=q_offset, kv_len=kv_len, kpos=kpos)
    if impl in ("chunked", "masked", "triangle"):
        return attention_chunked(
            q, k, v, causal=causal, window=window, q_chunk=q_chunk,
            kv_chunk=kv_chunk, impl="masked" if impl == "chunked" else impl)
    if impl == "pallas":
        return flash_attention(q, k, v, causal=causal, window=window)
    raise ValueError(impl)


# ------------------------------------------------------- attention (module)

def attn_qkv(p, x, cfg, *, positions=None, rope: bool = True):
    """Project to q,k,v (+qk_norm, +rope). x:(B,S,d) -> q(B,S,Hq,D), k/v.
    The head counts are the projections' own: a rank's shards give its
    local heads. In training under a rank, the replicated leaves used on
    the rank's heads — ``q_norm``/``k_norm``, and ``wk``/``wv`` kept whole
    where Hkv does not divide tp — get their gradient summed over
    "model" (``tp.enter``), except on a rank that runs every head, where
    the norms' gradient is whole already."""
    b, s, _ = x.shape
    wk, wv = p["wk"], p["wv"]
    if not tp.kv_split():
        wk, wv = tp.enter(wk, "kv_proj"), tp.enter(wv, "kv_proj")
    q = (x @ p["wq"]).reshape(b, s, -1, cfg.head_dim)
    k = (x @ wk).reshape(b, s, -1, cfg.head_dim)
    v = (x @ wv).reshape(b, s, -1, cfg.head_dim)
    if cfg.qk_norm:
        qn, kn = p["q_norm"], p["k_norm"]
        if not tp.whole_heads():
            qn, kn = tp.enter(qn, "qk_norm"), tp.enter(kn, "qk_norm")
        q = rmsnorm(q, qn, cfg.norm_eps)
        k = rmsnorm(k, kn, cfg.norm_eps)
    if rope:
        if positions is None:
            positions = torch.arange(s, device=x.device)[None, :]
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_out(p, ctx, cfg, *, sp: bool = False):
    """The output projection of the heads in ``ctx`` (a rank's local
    heads: its row block of ``wo``, summed over the ranks; ``sp``: the
    reduce-scatter to the rank's sequence slice; on a rank that runs
    every head, ``tp.heads_out``: no sum)."""
    b, s = ctx.shape[:2]
    return tp.heads_out(ctx.reshape(b, s, -1) @ p["wo"], "attn_out",
                        seq=sp)


# ----------------------------------------------------------------------- MLP

def mlp(p, x, *, sp: bool = False):
    """Gated (SwiGLU) MLP — the survey's §5.1 block — when ``w_gate`` is
    present, else the plain-GeLU MLP of the enc-dec family. SwiGLU with a
    gradient required (training) is the reference's plain matmul SwiGLU,
    which autograd differentiates; otherwise (serving) the fused kernel
    pair on CUDA tensors, its plain version on CPU tensors. The GeLU MLP
    is ``gelu(x @ w_up) @ w_down`` in plain PyTorch on either device, with
    ``jax.nn.gelu``'s default tanh form (the fused kernel computes SwiGLU
    only). Under a tensor-parallel mesh a rank holds column blocks of
    ``w_gate`` / ``w_up`` and the row block of ``w_down``: the kernel or
    its plain version gives the row-parallel partial, and one all-reduce
    sums it (the collective stays outside the kernel; ``sp``: the
    reduce-scatter to the rank's sequence slice)."""
    if "w_gate" not in p:
        y = F.gelu(x @ p["w_up"], approximate="tanh") @ p["w_down"]
    elif needs_grad(x, p["w_gate"], p["w_up"], p["w_down"]):
        y = (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    else:
        y = fused_mlp(x, p["w_gate"], p["w_up"], p["w_down"])
    return tp.reduce_out(y, "mlp_out", seq=sp)
