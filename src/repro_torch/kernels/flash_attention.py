"""Flash attention over a full sequence: the hand-written CUDA forward
kernel (``csrc/flash_attention.cu``), its plain PyTorch version, and the
``torch.autograd.Function`` that trains through it.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py::
flash_attention`` (body ``_kernel``) and its custom VJP
(``repro/kernels/ops.py::_flash_trainable``). The TPU kernel carries the
online-softmax state across the sequential kv axis of its grid; here one
thread block per (batch * query head, q tile) loops over its kv tiles; the
design and its bound are in the source's header note.

Contract: q ``(B, S, Hq, D)``; k/v ``(B, T, Hkv, D)`` with ``Hq % Hkv ==
0``; query head ``h`` reads kv head ``h // (Hq // Hkv)`` (no repeat in
HBM). Masks: causal ``kpos <= qpos``, ``window > 0``: ``kpos > qpos -
window``, positions counted from 0 in both S and T; ragged S and T are
masked, not padded. fp32 scores, running max, sum and accumulator; the
probabilities stay fp32 for P·V. Returns ``(B, S, Hq, D)`` in q's dtype. A
row with no live key writes 0 in the kernel (the Pallas ``safe_l``); the
plain version, like the reference oracle, gives such a row the mean of V.

Backward (:func:`flash_attention_bwd`): the port of ``ops.py::_flash_bwd``
— a softmax recompute with dk/dv summed over each GQA group. The reference
computes it in jnp outside any Pallas kernel; here it is plain PyTorch,
taken one kv-head group at a time so that at S = T = 4096 it holds four
``(B, Hq/Hkv, S, T)`` fp32 tensors (1.3 GB at B = 1, rep = 5), not four
of ``(B, Hq, S, T)`` (10.7 GB).

:func:`flash_attention` takes the plain version only for a tensor on the
CPU; on a CUDA tensor it launches the kernel or raises. On a meta tensor
it takes the branch of the device the tensor stands in for
(``kernels/dispatch.py``): for "cuda" the kernel's checks and output,
launching nothing. :func:`cost` is the kernel's work, charged on every
launch (``dispatch.charge``).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import build, dispatch
from repro_torch.kernels.ref import (NEG_INF, causal_window_mask,
                                     flash_attention_ref)


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0):
    """The reference oracle over KV repeated to Hq heads."""
    rep = q.shape[2] // k.shape[2]
    return flash_attention_ref(q, k.repeat_interleave(rep, dim=2),
                               v.repeat_interleave(rep, dim=2),
                               causal=causal, window=window)


def live_pairs(s: int, t: int, *, causal: bool, window: int) -> int:
    """(query, key) pairs the masks leave live in one (batch, head): the
    function's work, which the kernel does, skipping every key tile that
    holds none."""
    i = np.arange(s, dtype=np.int64)
    hi = np.minimum(i, t - 1) if causal else np.full(s, t - 1, np.int64)
    lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros(s,
                                                                    np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def cost(b: int, s: int, t: int, hq: int, hkv: int, d: int, *,
         causal: bool = True, window: int = 0, esize: int = 2):
    """(flops, bytes) of one forward: Q·Kᵀ and P·V over the live pairs
    (4·D a pair and query head), q and the output written once, K and V
    read once (``esize`` bytes an element)."""
    pairs = b * live_pairs(s, t, causal=causal, window=window)
    return (4.0 * hq * d * pairs,
            esize * (2 * b * s * hq * d + 2 * b * t * hkv * d))


def kernel_limits(dtype, hq: int, hkv: int, d: int) -> Optional[str]:
    """Why the kernel cannot take these heads, or None: the limits its C
    entries check (``csrc/flash_attention.cu`` header), stated on the host
    so that a caller (the wrapper, the trainer on a CUDA device) refuses
    before any launch."""
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    if dtype not in (torch.float32, torch.bfloat16):
        return f"takes float32 or bfloat16, not {dtype}"
    if hkv < 1 or hq < 1 or hq % hkv:
        return f"needs Hq ({hq}) a multiple of Hkv ({hkv})"
    if dtype == torch.float32:
        return None if 1 <= d <= 128 else \
            f"takes float32 head dims 1..128, not {d}"
    if d % 8 or not 8 <= d <= 128:
        return f"takes bfloat16 head dims that are multiples of 8 in " \
               f"8..128 (TMA's 16-byte rows), not {d}"
    return None


def launch_entry(q, k, v, out, *, causal: bool, window: int) -> int:
    """Call the C entry of q's dtype on these tensors and return its code:
    0, or the CUDA error it refused with (nothing launched then). No check
    on this side: the wrapper checks ``kernel_limits`` first, and the
    card's tests call this past them to hold the table to the C entries."""
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    lib = build.load("flash_attention")
    fn = lib.flash_attention_bf16 if q.dtype == torch.bfloat16 \
        else lib.flash_attention_f32
    return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              b, s, t, hq, hkv, d, int(causal), int(window),
              torch.cuda.current_stream(q.device).cuda_stream)


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0):
    """Launch the CUDA kernel on PyTorch's current stream (on meta
    tensors: its checks and output, no launch)."""
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    if k.shape != (b, t, hkv, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16 "
                        f"q/k/v of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    for a in (q, k, v):
        if not dispatch.on_card(a) or not a.is_contiguous():
            raise ValueError("flash_attention kernel takes contiguous CUDA "
                             "tensors")
    why = kernel_limits(q.dtype, hq, hkv, d)
    if why:
        raise ValueError(f"flash_attention kernel {why}")
    out = torch.empty_like(q)
    if not q.is_meta:
        # the C entry checks the same limits (csrc/flash_attention.cu)
        build.check(launch_entry(q, k, v, out, causal=causal,
                                 window=window),
                    f"flash_attention at Hq={hq} Hkv={hkv} D={d} S={s}")
        flash_attention.launches += 1
    dispatch.charge("flash_attention",
                    cost(b, s, t, hq, hkv, d, causal=causal, window=window,
                         esize=q.element_size()))
    return out


def flash_attention_bwd(q, k, v, g, *, causal: bool = True, window: int = 0):
    """dq, dk, dv of ``flash_attention`` by softmax recompute, in the
    inputs' dtypes (``ops.py::_flash_bwd``), one kv-head group at a
    time."""
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    rep = hq // hkv
    mask = causal_window_mask(s, t, causal=causal, window=window,
                              device=q.device)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    for grp in range(hkv):
        heads = slice(grp * rep, (grp + 1) * rep)
        qg = q[:, :, heads].float()                       # (B,S,rep,D)
        gg = g[:, :, heads].float()
        kg, vg = k[:, :, grp].float(), v[:, :, grp].float()  # (B,T,D)
        s32 = torch.einsum("bsrd,btd->brst", qg, kg) / math.sqrt(d)
        p = torch.softmax(s32.masked_fill(~mask, NEG_INF), dim=-1)
        del s32
        dv[:, :, grp] = torch.einsum("brst,bsrd->btd", p, gg).to(v.dtype)
        dp = torch.einsum("bsrd,btd->brst", gg, vg)
        dsoft = p * (dp - (dp * p).sum(-1, keepdim=True)) / math.sqrt(d)
        del dp, p
        dq[:, :, heads] = torch.einsum("brst,btd->bsrd", dsoft,
                                       kg).to(q.dtype)
        dk[:, :, grp] = torch.einsum("brst,bsrd->btd", dsoft,
                                     qg).to(k.dtype)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Forward: the kernel (CUDA, or meta for "cuda") or the plain version
    (CPU, or meta for "cpu"); backward:
    :func:`flash_attention_bwd` on both."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        if not dispatch.on_card(q):
            return flash_attention_plain(q, k, v, causal=causal,
                                         window=window)
        return flash_attention_cuda(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, g, causal=ctx.causal,
                                         window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Differentiable GQA flash attention, dispatched by device.
    ``flash_attention.launches`` counts kernel launches (each forward on
    a CUDA tensor, a remat recompute included)."""
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"query heads ({q.shape[2]}) must be a multiple "
                         f"of KV heads ({k.shape[2]})")
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), bool(causal), int(window))


flash_attention.launches = 0
