"""Paged-attention decode: the hand-written CUDA kernel
(``csrc/paged_attention.cu``) and its plain PyTorch version.

Replaces the Pallas TPU kernel ``repro/kernels/paged_attention.py::
paged_attention`` (body ``_kernel``), which runs the page axis as a
sequential grid dimension with the online-softmax state in VMEM. On the
card, bf16 rows that share pages are tiled together (one load of each page
for up to 64 / rep rows, on ``wgmma``), and a tile (or a lone row) whose
keys span more than one fixed 256-key segment is split across blocks, one
a segment; :func:`tile_plan` states the plan the kernel makes on the
device. A row's bits depend on its own q, table row and kv_len alone:
every row folds its own segments in the same order, lone or tiled. The
design and its bound are in the source's header note.

Contract (shared with ``models/layers.paged_attention`` of the JAX
package): q ``(B, 1, Hq, D)``; pools ``(n_pages, page_size, Hkv, D)``
with page 0 the null page; table ``(B, P)`` int32 pool indices in
logical-block order; pos ``(B,)`` int32 cursors — row ``b`` attends to
positions ``[0, pos[b]]`` (``kv_len = pos + 1``). Query head ``h`` reads
KV head ``h // (Hq // Hkv)``. Returns ``(B, 1, Hq, D)`` in q's dtype.

:func:`paged_attention` takes the plain version only for a tensor on the
CPU; on a CUDA tensor it launches the kernel or raises. On a meta tensor
it takes the branch of the device the tensor stands in for
(``kernels/dispatch.py``): for "cuda" the kernel's checks, output and
scratch (:func:`scratch_bytes`), launching nothing. :func:`cost` is the
kernel's work, charged on every launch.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import build, dispatch
from repro_torch.models.kvcache import gather_pages

NEG_INF = -1e30


def _attend_gathered(q, k_pages, v_pages, page_table, pos, *, p_fp32):
    """Gather each row's pages in logical order, mask to ``kv_len = pos +
    1`` and attend: fp32 scores and softmax; the probs enter P·V in fp32
    (``p_fp32``) or cast to q's dtype first."""
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
    probs = torch.softmax(scores, dim=-1)
    if not p_fp32:
        probs = probs.to(q.dtype)
    out = torch.einsum("bgrt,btgd->bgrd", probs.float(), v.float())
    return out.reshape(b, 1, hq, d).to(q.dtype)


def paged_attention_plain(q, k_pages, v_pages, page_table, pos):
    """Gather each row's pages in logical order, mask to ``kv_len =
    pos + 1`` and attend: fp32 scores, fp32 softmax, probs cast to q's
    dtype before P·V (the JAX gather path's arithmetic)."""
    return _attend_gathered(q, k_pages, v_pages, page_table, pos,
                            p_fp32=False)


def paged_attention_plain_f32p(q, k_pages, v_pages, page_table, pos):
    """The Pallas kernel's arithmetic on the gathered pages: fp32 scores
    and softmax, the probs kept fp32 for P·V with V upcast
    (``repro/kernels/paged_attention.py:67-89``) — what the bf16 kernel
    computes, so it is held to this one value by value."""
    return _attend_gathered(q, k_pages, v_pages, page_table, pos,
                            p_fp32=True)


#: the bf16 kernel's tiling (``csrc/paged_attention.cu``, namespace tc):
#: M rows a tile, keys a kv tile, kv tiles a key segment
TILE_M, TILE_KEYS, SPLIT_TILES = 64, 64, 4
SEGMENT_KEYS = TILE_KEYS * SPLIT_TILES


def rows_per_tile(rep: int) -> int:
    """Rows a tile: its M rows are rows x the ``rep`` query heads of one
    kv head."""
    return TILE_M // rep


def split_tiles(n_tiles: int):
    """(work items, kv tiles an item) of a tile whose last row has
    ``n_tiles`` tiles of ``TILE_KEYS`` keys: whole up to one key segment,
    else one item a segment of ``SPLIT_TILES`` tiles (the last may be
    short), with no cap on the count."""
    if n_tiles <= SPLIT_TILES:
        return 1, n_tiles
    return -(-n_tiles // SPLIT_TILES), SPLIT_TILES


def segments(kv_len: int):
    """The key segments a row of ``kv_len`` keys folds, in order:
    ``[start, end)`` key ranges fixed in absolute units of
    ``SEGMENT_KEYS``, the last cut at kv_len."""
    return [(k, min(k + SEGMENT_KEYS, kv_len))
            for k in range(0, max(kv_len, 0), SEGMENT_KEYS)]


def tile_plan(page_table, pos, page_size: int, rep: int):
    """The plan the bf16 kernel makes on the device (``paged_plan_kernel``),
    in numpy: row ``r`` joins row ``r - 1``'s run when it holds at least as
    many live pages and the two table rows agree over row ``r - 1``'s live
    pages; runs are cut into tiles of :func:`rows_per_tile` rows; a tile is
    split by :func:`split_tiles` of its last row's kv tiles. Returns
    ``(items, fold)``: items ``(first row, rows, segment or -1)`` in row
    order, and for each row the count of its own segments the combine
    kernel folds (a row of a split tile), or -1 (its whole item writes
    it)."""
    tab = np.asarray(page_table)
    n_blocks = tab.shape[1]
    kv = np.clip(np.asarray(pos, np.int64) + 1, 0, n_blocks * page_size)
    live = -(-kv // page_size)
    b, r_max = len(kv), rows_per_tile(rep)
    starts, run0 = [], 0
    for r in range(b):
        lp = live[r - 1] if r else 0
        joins = r > 0 and 0 < lp <= live[r] and \
            bool((tab[r, :lp] == tab[r - 1, :lp]).all())
        if not joins:
            run0 = r
        if (r - run0) % r_max == 0:
            starts.append(r)
    items, fold = [], np.full(b, -1, np.int64)
    for i, r in enumerate(starts):
        n_rows = (starts[i + 1] if i + 1 < len(starts) else b) - r
        count = split_tiles(-(-int(kv[r + n_rows - 1]) // TILE_KEYS))[0]
        items += [(r, n_rows, s if count > 1 else -1) for s in range(count)]
        if count > 1:
            fold[r:r + n_rows] = -(-kv[r:r + n_rows] // SEGMENT_KEYS)
    return items, fold


def row_segments(items, pos, page_size: int, n_blocks: int):
    """The key segments each row accumulates and folds under ``items``,
    as the kernel walks them: a split item the keys of its segment, a
    whole item every kv tile of its last row, folding at each segment's
    end (a row only the segments holding some of its keys). Returns row
    -> ``[start, end)`` key ranges in fold order, to hold against
    :func:`segments` of the row's own kv_len."""
    kv = np.clip(np.asarray(pos, np.int64) + 1, 0, n_blocks * page_size)
    out = {}
    for row0, n_rows, seg in items:
        last_tiles = -(-int(kv[row0 + n_rows - 1]) // TILE_KEYS)
        if seg >= 0:
            tb = seg * SPLIT_TILES
            spans = [(tb, min(last_tiles, tb + SPLIT_TILES))]
        else:
            spans = [(t, min(last_tiles, t + SPLIT_TILES))
                     for t in range(0, last_tiles, SPLIT_TILES)]
        for r in range(row0, row0 + n_rows):
            k = int(kv[r])
            out.setdefault(r, []).extend(
                (tb * TILE_KEYS, min(te * TILE_KEYS, k))
                for tb, te in spans if tb * TILE_KEYS < k)
    return out


#: page-table widths of :func:`neighbour_mixes`, in multiples of the pages
#: a mix's rows need
TABLE_WIDTHS = (1, 2, 4)


def neighbour_mixes(kv_len: int, page_size: int = 16, k: int = 4,
                    seed: int = 0):
    """Row structures around one row of ``kv_len`` keys (its cursor
    ``kv_len - 1``) that must not change its bits (prefix sharing and
    preemption change a row's neighbours): alone; first and last of a run
    of its slot's ``1 + k`` rows (a decode row and its verify rows, a
    re-prefilled chunk); after a shorter row of another slot that shares
    its first pages; before a longer row of a slot whose table agrees with
    its own over its live pages (a prefix hit). Each structure comes at
    every page-table width of :data:`TABLE_WIDTHS` (the engine's page
    bucket moves with the pool's high-water mark: speculative draft
    writes can widen it); columns past the pages a row holds are the null
    page. Returns ``(mixes, n_pages)``: name ->
    (table (B, P) int32, pos (B,) int32, the row's index), pages numbered
    ``1..n_pages - 1`` (page 0 the null page); "alone" is the lone row at
    the width it needs."""
    rng = np.random.default_rng(seed)
    width = -(-(kv_len + k + 64) // page_size)
    perm = rng.permutation(np.arange(1, 1 + 2 * width)).astype(np.int32)
    own, other = perm[:width], perm[width:]
    live = -(-kv_len // page_size)
    n_sh = max(live - 1, 1)
    short = other.copy()
    short[:n_sh] = own[:n_sh]               # shares all but the last page
    longer = other.copy()
    longer[:live] = own[:live]              # agrees over its live pages
    p = kv_len - 1
    mixes = {
        "alone": ([own], [p], 0),
        f"first of its slot's run of {1 + k}": (
            [own] * (k + 1), [p + i for i in range(k + 1)], 0),
        f"last of its slot's run of {1 + k}": (
            [own] * (k + 1), [max(p - k + i, 0) for i in range(k + 1)], k),
        "after a shorter row of a slot sharing its first pages": (
            [short, own], [max(min(n_sh * page_size, kv_len) - 4, 0), p], 1),
        "before a longer row of a slot sharing its pages": (
            [own, longer], [p, p + 37], 0),
    }
    out = {}
    for name, (t, q, r) in mixes.items():
        tab, pos = np.stack(t).astype(np.int32), np.asarray(q, np.int32)
        need = -(-(int(pos.max()) + 1) // page_size)
        for m in TABLE_WIDTHS:
            w = m * need
            wide = np.zeros((len(tab), w), np.int32)
            wide[:, :min(w, width)] = tab[:, :w]
            out[name if m == 1 else f"{name}, table {m}x its need"] = (
                wide, pos, r)
    return out, 1 + 2 * width


def device_tile_plan(page_table, pos, page_size: int, rep: int):
    """Run only the kernel's plan pass on the card and decode it as
    :func:`tile_plan` returns it (for tests)."""
    b, n_blocks = page_table.shape
    lib = build.load("paged_attention")
    plan = torch.zeros(scratch_bytes(b, rep, 8, n_blocks,
                                     page_size)[0] // 4,
                       dtype=torch.int32, device=page_table.device)
    code = lib.paged_attention_plan(
        page_table.data_ptr(), pos.data_ptr(), plan.data_ptr(), b,
        page_table.shape[1], page_size, rep,
        torch.cuda.current_stream(page_table.device).cuda_stream)
    build.check(code, "paged_attention plan")
    host = plan.cpu().numpy()
    at = (4 + 2 * b + 3) & ~3                 # tc::items_at(b)
    items = [tuple(int(x) for x in host[at + 4 * i:at + 4 * i + 3])
             for i in range(int(host[0]))]
    return items, host[4:4 + b].astype(np.int64)


#: the bf16 entry's page sizes: whole 1024-byte swizzle atoms, whole
#: pages a 64-key tile (csrc/paged_attention.cu)
BF16_PAGE_SIZES = (8, 16, 32, 64)


def kernel_limits(dtype, page_size: int, hq: int, hkv: int,
                  d: int) -> Optional[str]:
    """Why the kernel cannot take these shapes, or None: the limits its C
    entries check (``csrc/paged_attention.cu`` header), stated on the
    host so that a caller can refuse before any launch. The wrapper and
    the serving engine, on a CUDA device, both ask this one function."""
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    if dtype not in (torch.float32, torch.bfloat16):
        return f"takes float32 or bfloat16, not {dtype}"
    if hkv < 1 or hq < 1 or hq % hkv:
        return f"needs Hq ({hq}) a multiple of Hkv ({hkv})"
    if hq // hkv > 16:
        return f"takes Hq / Hkv <= 16, not {hq // hkv}"
    if dtype == torch.float32:
        if not 1 <= d <= 256:
            return f"takes float32 head dims 1..256, not {d}"
        if not 1 <= page_size <= 128:
            return f"takes float32 page sizes 1..128, not {page_size}"
        return None
    if d % 8 or not 8 <= d <= 128:
        return f"takes bfloat16 head dims that are multiples of 8 in " \
               f"8..128 (TMA's 16-byte rows), not {d}"
    if page_size not in BF16_PAGE_SIZES:
        return f"takes bfloat16 page sizes {BF16_PAGE_SIZES}, not " \
               f"{page_size}"
    return None


#: keys a split segment (``SPLIT_TILES`` x ``BN`` of csrc/paged_attention.cu)
SEGMENT_KEYS = 256


def scratch_bytes(b: int, hq: int, d: int, n_blocks: int, page_size: int):
    """Bytes of the bf16 entry's plan and split partials at (B, Hq, D) over
    a table of ``n_blocks`` pages, the plan's rounded up to 256 so that the
    partials stay aligned: the C entry's ``paged_attention_bf16_scratch``
    (plan ints ``items_at(b) + 4 b segs``, partials ``b segs Hq (D + 2)``
    floats, ``segs`` a row's key segments). :func:`c_scratch_bytes` asks
    the built library; the card's tests hold the two equal."""
    segs = -(-n_blocks * page_size // SEGMENT_KEYS)
    plan = ((4 + 2 * b + 3) & ~3) + 4 * b * segs
    return -(-plan * 4 // 256) * 256, b * segs * hq * (d + 2) * 4


def c_scratch_bytes(lib, b: int, hq: int, d: int, n_blocks: int,
                    page_size: int):
    """:func:`scratch_bytes` from the C entry's own sizes."""
    sizes = (ctypes.c_longlong * 2)()
    lib.paged_attention_bf16_scratch(b, hq, d, n_blocks, page_size, sizes)
    return -(-sizes[0] * 4 // 256) * 256, sizes[1] * 4


def live_tokens(page_table: np.ndarray, pos: np.ndarray,
                page_size: int) -> int:
    """Distinct (page, slot) positions the rows read: each row reads the
    first ``kv_len = pos + 1`` positions of its table (clamped to it), and
    a page that rows share is read once."""
    b, width = page_table.shape
    kv = np.clip(pos.astype(np.int64) + 1, 0, width * page_size)
    held = np.zeros(int(page_table.max(initial=0)) + 1, np.int64)
    cols = np.arange(width)
    for r in range(b):
        fill = np.clip(kv[r] - cols * page_size, 0, page_size)
        np.maximum.at(held, page_table[r], fill)
    return int(held.sum())


def cost(page_table, pos, hq: int, hkv: int, d: int, page_size: int, *,
         esize: int = 2):
    """(flops, bytes) of one call: Q·Kᵀ and P·V over each row's ``kv_len``
    keys (4·D a key and query head), the distinct live K and V read once
    (:func:`live_tokens`), q and the output, the table and the cursors
    (int32). ``page_table`` and ``pos`` are host arrays; None for a meta
    stand-in, which has no data: then every row at its table's full width
    over pages of its own (the most the call could need)."""
    if page_table is None:
        b, width = pos
        kv_sum = live = b * width * page_size
        tab_n, pos_n = b * width, b
    else:
        b, width = page_table.shape
        kv_sum = int(np.clip(pos.astype(np.int64) + 1, 0,
                             width * page_size).sum())
        live = live_tokens(page_table, pos, page_size)
        tab_n, pos_n = page_table.size, pos.size
    return (4.0 * hq * d * kv_sum,
            live * hkv * d * 2 * esize + 2 * b * hq * d * esize
            + 4 * (tab_n + pos_n))


def launch_entry(q, k_pages, v_pages, page_table, pos, out) -> int:
    """Call the C entry of q's dtype on these tensors and return its code:
    0, or the CUDA error it refused with (nothing launched then). No check
    on this side: the wrapper checks ``kernel_limits`` first, and the
    card's tests call this past them to hold the table to the C entries."""
    b, _, hq, d = q.shape
    n_pages, page_size, hkv, _ = k_pages.shape
    lib = build.load("paged_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if q.dtype == torch.bfloat16:
        # the plan and the split partials (csrc/paged_attention.cu), one
        # allocation
        plan_bytes, part_bytes = scratch_bytes(b, hq, d,
                                               page_table.shape[1],
                                               page_size)
        scratch = torch.empty(plan_bytes + part_bytes, dtype=torch.uint8,
                              device=q.device)
        return lib.paged_attention_bf16(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), pos.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), scratch.data_ptr() + plan_bytes, b, hq, hkv,
            d, page_size, n_pages, page_table.shape[1], stream)
    return lib.paged_attention_f32(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), pos.data_ptr(), out.data_ptr(), b, hq, hkv,
        d, page_size, page_table.shape[1], stream)


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
        if not dispatch.on_card(t) or not t.is_contiguous():
            raise ValueError("paged_attention kernel takes contiguous CUDA "
                             "tensors")
    why = kernel_limits(q.dtype, page_size, hq, hkv, d)
    if why:
        raise ValueError(f"paged_attention kernel {why}")
    out = torch.empty_like(q)
    scratch = sum(scratch_bytes(b, hq, d, page_table.shape[1], page_size)) \
        if q.dtype == torch.bfloat16 else 0
    if q.is_meta:
        if scratch:                   # launch_entry's allocation only
            torch.empty(scratch, dtype=torch.uint8, device=q.device)
        work = cost(None, tuple(page_table.shape), hq, hkv, d, page_size,
                    esize=q.element_size())
    else:
        # the C entry checks the same limits (csrc/paged_attention.cu)
        code = launch_entry(q, k_pages, v_pages, page_table, pos, out)
        if code:
            build.check(code, f"paged_attention at Hq={hq} Hkv={hkv} D={d} "
                              f"page_size={page_size}")
        paged_attention.launches += 1

        def work():
            return cost(page_table.cpu().numpy(), pos.cpu().numpy(), hq,
                        hkv, d, page_size, esize=q.element_size())
    dispatch.charge("paged_attention", work, scratch)
    return out


def paged_attention(q, k_pages, v_pages, page_table, pos):
    """Dispatch by device: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors (a meta tensor takes the branch of the device
    it stands in for). ``paged_attention.launches`` counts kernel
    launches."""
    if not dispatch.on_card(q):
        return paged_attention_plain(q, k_pages, v_pages, page_table, pos)
    return paged_attention_cuda(q, k_pages, v_pages, page_table, pos)


paged_attention.launches = 0
