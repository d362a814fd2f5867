"""Paged KV cache (vLLM-style block tables) — the port of the paged half
of ``repro/models/kvcache.py``.

One flat pool of fixed-size pages ``(layers, n_pages, page_size, Hkv, D)``
is shared by every slot, plus a per-slot page table of pool indices:
token ``p`` of slot ``b`` lives at ``pool[ptab[b, p // page_size],
p % page_size]``. Page 0 is the NULL page: padding rows and inactive
slots write there, and table entries beyond a slot's reservation point at
it (always masked by ``kv_len = pos + 1``).

Unlike the JAX package (immutable arrays), the scatter updates the pool
IN PLACE: the engine holds one pool for its lifetime and never copies it.
The dense and ring layouts wait for a later slice (ROADMAP.md Queue 1
item 3).
"""
from __future__ import annotations

import torch


def init_paged_kv(layers: int, n_pages: int, page_size: int, n_kv: int,
                  head_dim: int, dtype, device):
    """Flat page pool shared by every slot. ``n_pages`` INCLUDES the null
    page 0 (so a pool serving K usable pages has n_pages = K + 1)."""
    shape = (layers, n_pages, page_size, n_kv, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def write_kv_paged(cache, k_new, v_new, page_table, pos):
    """Scatter one token per row through the page table, in place.

    cache leaves: (n_pages, page_size, Hkv, D) — ONE layer's pool (views
    into the stacked pool). k_new/v_new: (B, 1, Hkv, D); page_table:
    (B, P); pos: (B,) per-row cursors. The block index is clipped to the
    table width, so a cursor past it resolves to the table's last entry
    (the null page for inactive rows) and the scatter is total. Rows that
    share a target (only ever the null page) leave one of their values
    there, which nothing reads.
    """
    page_size = cache["k"].shape[1]
    pos = pos.long()
    rows = torch.arange(page_table.shape[0], device=pos.device)
    blk = torch.clamp(pos // page_size, 0, page_table.shape[1] - 1)
    page = page_table[rows, blk].long()
    off = pos % page_size
    cache["k"][page, off] = k_new[:, 0]
    cache["v"][page, off] = v_new[:, 0]
    return cache


def gather_pages(pool, page_table):
    """pool: (n_pages, page_size, ...); page_table: (B, P) -> contiguous
    per-row KV (B, P * page_size, ...) in logical position order."""
    b, p = page_table.shape
    out = pool[page_table.long()]
    return out.reshape(b, p * pool.shape[1], *pool.shape[2:])
