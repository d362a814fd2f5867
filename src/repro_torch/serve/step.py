"""Host helpers of the serve step — the port's copies of the pure
functions of ``repro/serve/step.py``: prompt-length and page-table
bucketing and the mixed step's token-budget packer."""
from __future__ import annotations

MIN_PREFILL_BUCKET = 8


def prefill_bucket(n: int, *, cap: int = 0,
                   min_bucket: int = MIN_PREFILL_BUCKET) -> int:
    """Padded prompt length for an ``n``-token prompt: the smallest
    power of two >= max(n, min_bucket).

    Bucketing bounds the number of distinct prefill shapes — and therefore
    XLA retraces — to log2(max_len) instead of one per prompt length.
    ``cap`` > 0 bounds the padded length (the cache window); when even the
    bucket would overflow it, fall back to the exact length so the cache
    layout stays consistent (``kvcache.fit_prefill`` would otherwise keep
    padding rows and drop real ones).
    """
    assert n >= 1
    b = max(n, min_bucket)
    b = 1 << (b - 1).bit_length()
    if cap > 0 and b > cap:
        return n
    return b


def page_bucket(n_blocks: int, *, cap: int) -> int:
    """Bucketed page-table width for the engine's bounded paged-attention
    gather: the smallest power of two >= ``n_blocks`` (the allocator's
    per-owner page high-water mark), clipped to ``cap`` (the full table
    width, ``pages_for(max_len)``). Bucketing means the decode program
    only retraces when occupancy crosses a power-of-two block boundary —
    cost tracks the pool's live high-water mark, not ``max_len``, while
    the one-decode-trace property holds between re-bucketings."""
    assert n_blocks >= 1 and cap >= 1
    return min(cap, 1 << (n_blocks - 1).bit_length())


def pack_token_budget(budget: int, decode_rows, prefill_items):
    """Fill one mixed step's token budget: decode first, then prefill
    chunks in the given order (the scheduler's priority order).

    ``decode_rows`` is either the total decode row count (the classic
    one-row-per-slot step) or a sequence of PER-SLOT row counts — the
    speculative-decode hook: a slot verifying ``k`` drafted tokens
    occupies ``1 + k`` rows (its base decode row plus the draft rows),
    and every one of them is reserved ahead of prefill. Only the sum
    matters to the packing; the sequence form exists so callers state
    per-slot demand directly and the property tests can pin that drafted
    rows are never displaced.

    ``prefill_items`` are dicts with ``slot``, ``cursor`` (prompt tokens
    already prefilled), ``n`` (total prompt tokens) and optional ``dep``
    — a ``(donor_slot, needed_tokens)`` pair meaning this item adopted
    the donor's shared pages up to ``needed_tokens`` and must not run a
    chunk until the donor's PLANNED coverage (its cursor after this
    step's allotments) reaches that point; same-step coverage counts
    because the mixed program scatters every chunk's KV before any token
    attends (serve/engine._mixed_fn).

    Returns ``[(slot, start, count), ...]`` with ``count >= 1``,
    ``sum(count) <= budget - sum(decode_rows)``. Decode (and draft) rows
    are reserved FIRST — prefill never displaces them — and a step whose
    decode demand alone exceeds the budget is a sizing bug, so it
    raises. Pure host logic; the hypothesis suite in
    tests/test_serve_mixed.py drives it across random mixes.
    """
    n_decode = decode_rows if isinstance(decode_rows, int) \
        else sum(decode_rows)
    if n_decode > budget:
        raise ValueError(
            f"decode demand {n_decode} exceeds the token budget {budget}; "
            "chunk_tokens must be >= the slot count")
    left = budget - n_decode
    planned_end = {it["slot"]: it["cursor"] for it in prefill_items}
    allot = []
    for it in prefill_items:
        if left <= 0:
            break
        dep = it.get("dep")
        if dep is not None:
            donor, needed = dep
            if planned_end.get(donor, needed) < needed:
                continue
        take = min(left, it["n"] - it["cursor"])
        if take <= 0:
            continue
        allot.append((it["slot"], it["cursor"], take))
        planned_end[it["slot"]] = it["cursor"] + take
        left -= take
    return allot
