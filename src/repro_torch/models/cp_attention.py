"""Context-parallel decode attention — the port of
``repro/models/cp_attention.py``.

Where a rank holds a SEQUENCE slice of the dense K/V cache (every K/V
head of positions ``[start, start + length)``, ``core/tp.py::
cache_rows``), one decode step's attention is computed slice-locally:

* the query heads (and the new K/V row where the heads are sharded) are
  assembled over the "model" group by one zero-filled sum;
* the rank that owns the cursor writes the new K/V row, in place;
* each rank computes online-softmax partials (m, l, o) in fp32 over its
  slice (``local_stats``);
* one MAX of m and one SUM of the packed ``(l * corr, o * corr)``,
  ``corr = exp(m - m_max)``, combine them (``combine``).

A layer and a step move O(B * Hq * D) bytes, not the cache. The
reference runs the same arithmetic in a ``shard_map`` with ``pmax`` /
``psum``; the port uses only ``all_reduce`` (SUM, MAX), which gloo also
runs on CUDA tensors.

  cp_available(cfg, cache, pos)                       -> bool
  local_stats(q, k, v, kpos, pos, window)             -> m, l, o
  cp_decode_attention(q, kv, k_new, v_new, pos, window=, rows=, ring=)
                                                      -> ctx
  cp_cross_attention(q, kv, rows=)                    -> ctx

``cp_cross_attention`` is the same arithmetic over a block that is not
written and has no cursor: the enc-dec family's cross K/V on the rank's
slice of the encoder positions (every position valid), one sum
assembling the query heads (``cp_xq``), then the same MAX and SUM.

``pos`` is a scalar (the lockstep loop) or per-row (B,) cursors (the
serving engine's dense rows, which the reference's GSPMD program gathers
instead: the same arithmetic up to the order of the sums).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import tp
from repro_torch.kernels import dispatch
from repro_torch.models import kvcache

#: the reference's mask value (cp_attention.py:58)
MASKED = -1e30


def cp_available(cfg, cache, pos) -> bool:
    """The reference's ``use_cp`` (transformer.py:194-196 with
    ``cp_available``): ``cfg.cp_decode``, a live rank, a dense cache
    that is no ring and no page table, a scalar ``pos``, and the cache's
    positions dividing tp."""
    r = tp.current()
    if not cfg.cp_decode or r is None or r.tp < 2 or "ptab" in cache:
        return False
    if torch.as_tensor(pos).ndim:
        return False
    sl = cache.get("kv_slice")
    total = sl.total if sl is not None else cache["kv"]["k"].shape[2]
    ring = cfg.sliding_window > 0 and total == cfg.sliding_window
    return not ring and total % r.tp == 0


def local_stats(q, k, v, kpos, pos, window: int):
    """Online-softmax partials over a K/V slice, in fp32: grouped-query
    attention (no repeated K/V), masked as the reference's
    ``_local_attn_stats`` (:55-58): ``kpos <= pos``, ``kpos >= 0`` and,
    with a window, ``kpos > pos - window``.

    q (B, 1, Hq, D); k, v (B, n, Hkv, D); kpos (n,) or (B, n); pos scalar
    or (B,). Returns m, l (B, Hq) and o (B, Hq, D). A row whose slice is
    all masked gets m = -1e30, which the combine weighs by 0.

    On CUDA in bf16 / fp16 each KV group's scores come from one ``bmm``
    with an fp32 output (no fp32 copy of the slice), and P is cast to
    the cache's dtype for P.V, accumulated in fp32, as the plain
    attention does; otherwise the products are fp32 einsums."""
    b, _, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, d)
    half = dispatch.on_card(q) and k.dtype != torch.float32
    if half:
        s = torch.stack([torch.bmm(qg[:, g], k[:, :, g].transpose(1, 2),
                                   out_dtype=torch.float32)
                         for g in range(hkv)], 1)
    else:
        s = torch.einsum("bgrd,btgd->bgrt", qg.float(), k.float())
    s = s * (1.0 / np.sqrt(d))
    pos = torch.as_tensor(pos, device=q.device).reshape(-1, 1)   # (1|B, 1)
    kpos = kpos.reshape(-1, kpos.shape[-1])                       # (1|B, n)
    mask = (kpos <= pos) & (kpos >= 0)
    if window > 0:
        mask = mask & (kpos > pos - window)
    s = s.masked_fill(~mask[:, None, None, :], MASKED)
    m = s.amax(-1)                                            # (B, g, r)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    if half:
        p = p.to(v.dtype)
        o = torch.stack([torch.bmm(p[:, g], v[:, :, g],
                                   out_dtype=torch.float32)
                         for g in range(hkv)], 1)
    else:
        o = torch.einsum("bgrt,btgd->bgrd", p, v.float())
    return m.reshape(b, hq), l.reshape(b, hq), o.reshape(b, hq, d)


def combine(m, l, o):
    """The global softmax of the ranks' partials: one MAX of ``m`` and
    one SUM of ``(l * corr, o * corr)`` packed, ``corr = exp(m - m_g)``;
    ``l_g`` of 0 becomes 1 (:110). Returns ctx (B, Hq, D) in fp32."""
    m_g = tp.all_reduce(m.clone(), "cp_max", op=dist.ReduceOp.MAX)
    corr = torch.exp(m - m_g)
    packed = torch.cat([(l * corr)[..., None], o * corr[..., None]], -1)
    packed = tp.all_reduce(packed, "cp_sum")
    l_g, o_g = packed[..., 0], packed[..., 1:]
    safe = torch.where(l_g == 0.0, torch.ones_like(l_g), l_g)
    return o_g / safe[..., None]


def _write_row(kv, k_new, v_new, at, n: int):
    """Write each row's new K/V at local index ``at`` (B,), in place,
    where ``0 <= at < n`` (the rank owns the cursor); other rows keep
    what they hold."""
    b = at.shape[0]
    rows = torch.arange(b, device=at.device)
    live = ((at >= 0) & (at < n))[:, None, None]
    idx = at.clamp(0, n - 1).long()
    for leaf, new in ((kv["k"], k_new), (kv["v"], v_new)):
        leaf[rows, idx] = torch.where(live, new[:, 0], leaf[rows, idx])


def _slice_rank(what: str):
    """The live rank a cache slice decodes under; ``ValueError`` without
    one: a slice alone holds only part of each row's keys."""
    r = tp.current()
    if r is None or r.tp < 2:
        raise ValueError(f"a cache of a rank's sequence slice ({what}) "
                         "decodes only under that rank (tp.active)")
    return r


def cp_cross_attention(q, kv, *, rows: tp.SeqSlice):
    """Non-causal attention of q over a K/V block sequence-sharded over
    "model" (every position of the rank's slice ``rows`` valid): the
    rank's query heads assembled by one zero-filled sum (``cp_xq``),
    fp32 partials over the slice (``local_stats``) and ``combine``'s one
    MAX and one SUM.

    q (B, 1, h, D): the rank's h = Hq / tp query heads; kv {"k", "v"}
    (B, n, Hkv, D): the rank's slice of every head. Returns ctx (B, 1, h,
    D) in q's dtype, the rank's heads. Raises ``ValueError`` without a
    live rank."""
    h = q.shape[2]
    r = _slice_rank("xkv_slice")
    (q_all,) = tp.gather_heads([q], [h * r.tp], "cp_xq")
    n = rows.length
    kpos = torch.arange(n, device=q.device)
    ctx = combine(*local_stats(q_all, kv["k"], kv["v"], kpos, n, 0))
    return ctx[:, r.rank * h:(r.rank + 1) * h].to(q.dtype)[:, None]


def cp_decode_attention(q, kv, k_new, v_new, pos, *, window: int = 0,
                        rows: tp.SeqSlice, ring: bool = False):
    """One decode step's attention over a sequence-sharded cache, and its
    write.

    q (B, 1, h, D): the rank's h = Hq / tp query heads; kv {"k", "v"}
    (B, n, Hkv, D): the rank's slice ``rows`` of every head; k_new /
    v_new (B, 1, Hkv / tp or Hkv, D): the rank's K/V heads of the new
    token; pos scalar or (B,). On a ring (``ring``) slot ``p % W`` holds
    position p. Returns ctx (B, 1, h, D) in q's dtype: the rank's heads,
    for its row block of ``wo``. Raises ``ValueError`` without a live
    rank: a slice alone holds only part of each row's keys."""
    b, _, h, d = q.shape
    r = _slice_rank("kv_slice")
    q_all, k_new, v_new = tp.gather_heads(
        [q, k_new, v_new], [h * r.tp] + [kv["k"].shape[2]] * 2, "cp_qkv")
    n = rows.length
    pos = torch.as_tensor(pos, device=q.device)
    cur = pos.expand(b)
    slot = kvcache.ring_slot(cur, rows.total) if ring else cur
    _write_row(kv, k_new, v_new, slot - rows.start, n)
    if ring:
        kpos = kvcache.ring_kpos(pos.reshape(-1, 1), rows.total)[
            :, rows.start:rows.start + n]
    else:
        kpos = rows.start + torch.arange(n, device=q.device)
    ctx = combine(*local_stats(q_all, kv["k"], kv["v"], kpos, pos,
                               window))
    return ctx[:, r.rank * h:(r.rank + 1) * h].to(q.dtype)[:, None]
