"""KV-cache utilities of the dense decoder — the port of
``repro/models/kvcache.py``. Three layouts:

* linear: per-row ``(B, S, Hkv, D)``, token ``p`` at row position ``p``;
* ring (sliding-window configs): ``(B, W, Hkv, D)``, token ``p`` in slot
  ``p % W``; ``ring_kpos`` recomputes which absolute position each slot
  holds, so memory is O(W), not O(S);
* paged, below.

``pos`` may be a scalar (the lockstep generate loop) or a per-row ``(B,)``
vector (the serve engine's slot table, each request at its own depth):
``write_kv`` then scatters row-wise and the attention mask takes per-row
``q_offset`` / ``kv_len`` / ``kpos``.

Paged layout: one flat pool of fixed-size pages ``(layers, n_pages,
page_size, Hkv, D)`` is shared by every slot, plus a per-slot page table
of pool indices: token ``p`` of slot ``b`` lives at
``pool[ptab[b, p // page_size], p % page_size]``. Page 0 is the NULL
page: padding rows and inactive slots write there, and table entries
beyond a slot's reservation point at it (always masked by ``kv_len = pos
+ 1``).

Unlike the JAX package (immutable arrays), the scatter updates the pool
IN PLACE, as do ``write_kv`` and ``copy_page``: the engine holds one
cache for its lifetime and never copies it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def init_kv(batch: int, length: int, n_kv: int, head_dim: int, dtype,
            device=None):
    shape = (batch, length, n_kv, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


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


def copy_page(pool, src, dst):
    """Copy one physical page's contents, all layers at once, in place —
    the device half of copy-on-write. pool leaves: (L, n_pages,
    page_size, Hkv, D); src/dst: page ids."""
    for leaf in pool.values():
        leaf[:, dst] = leaf[:, src]
    return pool


def gather_pages(pool, page_table):
    """pool: (n_pages, page_size, ...); page_table: (B, P) -> contiguous
    per-row KV (B, P * page_size, ...) in logical position order."""
    b, p = page_table.shape
    out = pool[page_table.long()]
    return out.reshape(b, p * pool.shape[1], *pool.shape[2:])


def ring_slot(pos, window: int):
    return pos % window


def ring_kpos(pos, window: int):
    """Absolute position held by each ring slot at time ``pos`` (< 0 for
    slots not filled yet; the attention mask drops those). ``pos`` scalar
    -> (W,); ``pos`` (B, 1) -> (B, W) per-row maps."""
    pos = torch.as_tensor(pos)
    i = torch.arange(window, device=pos.device)
    return pos - ((pos - i) % window)


def fit_prefill(k, w: int):
    """Fit freshly computed prefill K or V (B, S, Hkv, D) into a cache of
    length ``w``. S >= w: keep the last w, rolled so that absolute position
    ``p`` lands in ring slot ``p % w`` (what ``ring_kpos`` assumes). S < w:
    at the front, the tail zero (linear, and ring-consistent as p < w)."""
    s = k.shape[1]
    if s >= w:
        return torch.roll(k[:, s - w:], s % w, dims=1)
    return F.pad(k, (0, 0, 0, 0, 0, w - s))


def write_kv(cache, k_new, v_new, pos, *, ring: bool = False,
             window: int = 0):
    """Write one token a row, in place. k_new/v_new: (B, 1, Hkv, D); pos:
    scalar (lockstep: every row at one cursor) or (B,) per-row cursors.
    A cursor past the cache writes nothing, as the reference's scatter
    drops out-of-bounds updates (a retired slot's frozen cursor)."""
    k = cache["k"]
    b, t = k.shape[0], k.shape[1]
    pos = torch.as_tensor(pos, device=k.device)
    idx = (ring_slot(pos, window) if ring else pos).long().expand(b)
    rows = torch.arange(b, device=k.device)
    live = (idx < t)[:, None, None]
    at = idx.clamp(max=t - 1)
    for leaf, new in ((k, k_new), (cache["v"], v_new)):
        leaf[rows, at] = torch.where(live, new[:, 0], leaf[rows, at])
    return cache
