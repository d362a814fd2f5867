"""Paged-attention decode: the hand-written CUDA kernel
(``csrc/paged_attention.cu``) and its plain PyTorch version.

Replaces the Pallas TPU kernel ``repro/kernels/paged_attention.py::
paged_attention`` (body ``_kernel``), which runs the page axis as a
sequential grid dimension with the online-softmax state in VMEM. Here one
thread block per (row, kv-head) loops over the row's live pages itself;
the design and its bound are in the source's header note.

Contract (shared with ``models/layers.paged_attention`` of the JAX
package): q ``(B, 1, Hq, D)``; pools ``(n_pages, page_size, Hkv, D)``
with page 0 the null page; table ``(B, P)`` int32 pool indices in
logical-block order; pos ``(B,)`` int32 cursors — row ``b`` attends to
positions ``[0, pos[b]]`` (``kv_len = pos + 1``). Query head ``h`` reads
KV head ``h // (Hq // Hkv)``. Returns ``(B, 1, Hq, D)`` in q's dtype.

:func:`paged_attention` takes the plain version only for a tensor on the
CPU; on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.models.kvcache import gather_pages

NEG_INF = -1e30


def paged_attention_plain(q, k_pages, v_pages, page_table, pos):
    """Gather each row's pages in logical order, mask to ``kv_len =
    pos + 1`` and attend: fp32 scores, fp32 softmax, probs cast to q's
    dtype before P·V (the JAX gather path's arithmetic)."""
    b, _, hq, d = q.shape
    _, page_size, hkv, _ = k_pages.shape
    p = page_table.shape[1]
    k = gather_pages(k_pages, page_table)
    v = gather_pages(v_pages, page_table)
    # consecutive query heads share one KV head: head h = g * rep + r
    qg = q.reshape(b, hkv, hq // hkv, d)
    scores = torch.einsum("bgrd,btgd->bgrt", qg.float(), k.float())
    scores = scores * (1.0 / math.sqrt(d))
    kpos = torch.arange(p * page_size, device=q.device)
    live = kpos[None, :] < (pos.long() + 1)[:, None]            # (B, T)
    scores = scores.masked_fill(~live[:, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bgrt,btgd->bgrd", probs.float(), v.float())
    return out.reshape(b, 1, hq, d).to(q.dtype)


def paged_attention_cuda(q, k_pages, v_pages, page_table, pos):
    """Launch the CUDA kernel on PyTorch's current stream."""
    b, s, hq, d = q.shape
    n_pages, page_size, hkv, dk = k_pages.shape
    if s != 1 or dk != d or v_pages.shape != k_pages.shape:
        raise ValueError(f"paged_attention: q {tuple(q.shape)} / pools "
                         f"{tuple(k_pages.shape)}, {tuple(v_pages.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(f"paged_attention kernel takes float32 or bfloat16 "
                        f"q/pools of one dtype, got {q.dtype}, "
                        f"{k_pages.dtype}, {v_pages.dtype}")
    if page_table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError("paged_attention kernel takes int32 table and pos")
    if page_table.shape[0] != b or pos.shape != (b,):
        raise ValueError(f"table {tuple(page_table.shape)} / pos "
                         f"{tuple(pos.shape)} do not match B={b}")
    for t in (q, k_pages, v_pages, page_table, pos):
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError("paged_attention kernel takes contiguous CUDA "
                             "tensors")
    out = torch.empty_like(q)
    lib = build.load("paged_attention")
    fn = lib.paged_attention_bf16 if q.dtype == torch.bfloat16 \
        else lib.paged_attention_f32
    code = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
              page_table.data_ptr(), pos.data_ptr(), out.data_ptr(),
              b, hq, hkv, d, page_size, page_table.shape[1],
              torch.cuda.current_stream(q.device).cuda_stream)
    # the kernel checks its own shape limits (csrc/paged_attention.cu)
    build.check(code, f"paged_attention at Hq={hq} Hkv={hkv} D={d} "
                      f"page_size={page_size}")
    paged_attention.launches += 1
    return out


def paged_attention(q, k_pages, v_pages, page_table, pos):
    """Dispatch by device: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors. ``paged_attention.launches`` counts kernel
    launches."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, page_table, pos)
    return paged_attention_cuda(q, k_pages, v_pages, page_table, pos)


paged_attention.launches = 0
