"""Serving steps — the port of ``repro/serve/step.py``: prefill and
single-token decode, prompt-length and page-table bucketing, the mixed
step's token-budget packer, the page-wise prefill scatter for the
engine's paged KV layout, and the lockstep greedy/sampled generate loop.
The host helpers are copies of the reference's pure functions."""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core import tp
from repro_torch.models import get_model
from repro_torch.serve.sampling import sample_tokens
from repro_torch.tree import tree_map

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


def scatter_prefill_pages(pool, kvs, pages, page_size: int):
    """Write a freshly prefilled per-request KV into its pool pages, in
    place. pool leaves: (L, n_pages, page_size, Hkv, D) — the engine's
    shared pool. kvs leaves: (L, 1, S, Hkv, D) with S a multiple of
    ``page_size`` (the prefill cache is sized to whole pages). pages:
    (S // page_size,) pool indices; entries past the slot's reservation
    are the null page 0, so bucket padding lands in scratch instead of a
    neighbour's page."""
    for key, leaf in pool.items():
        kv = kvs[key]
        l, _, s, h, d = kv.shape
        leaf[:, pages.long()] = kv.reshape(l, s // page_size, page_size, h,
                                           d)
    return pool


def make_prefill_step(cfg, strategy) -> Callable:
    """prefill_step(params, batch) -> (last-token logits, cache). With
    ``strategy.microbatches`` > 1 dividing the batch, the batch is run in
    that many chunks (bounding the transient activations to one chunk)
    and the caches joined on the batch axis."""
    model = get_model(cfg)
    n_micro = strategy.microbatches

    def one(params, batch):
        tokens = batch["tokens"]
        cache = model.init_cache(cfg, tokens.shape[0], tokens.shape[1],
                                 device=tokens.device)
        return model.prefill(params, batch, cfg, cache,
                             attn_impl=strategy.attn_impl)

    def prefill_step(params, batch):
        b = batch["tokens"].shape[0]
        if n_micro <= 1 or b % n_micro:
            return one(params, batch)
        size = b // n_micro
        parts = [one(params, {k: v[i:i + size] for k, v in batch.items()})
                 for i in range(0, b, size)]
        logits = torch.cat([lg for lg, _ in parts], dim=0)

        def join(*leaves):
            if leaves[0].ndim <= 1:     # the scalar cursor: one per chunk
                return leaves[0]
            return torch.cat(leaves, dim=1)   # (L, b/n, ...) -> (L, b, ...)

        caches = [c for _, c in parts]
        return logits, tree_map(join, caches[0], *caches[1:])

    return prefill_step


def make_decode_step(cfg, strategy) -> Callable:
    """decode_step(params, cache, token, pos): ONE new token against the
    cache (updated in place)."""
    model = get_model(cfg)

    def decode_step(params, cache, token, pos):
        return model.decode_step(params, cache, token, pos, cfg)

    return decode_step


@torch.no_grad()
def greedy_generate(params, cfg, strategy, prompt, steps: int, *,
                    temperature: float = 0.0,
                    generator: Optional[torch.Generator] = None):
    """The lockstep generate loop: prefill the prompt batch (``"tokens"``
    (B, S), and ``"frames"`` for the enc-dec family or ``"image_embeds"``
    for the VLM) into a cache of S +
    steps positions, then ``steps - 1`` single-token decodes.
    Greedy by default; ``temperature > 0`` with a ``generator`` samples
    through the engine's sampler (seeded within the port: it cannot replay
    ``jax.random``). Returns (B, steps) int32 on the prompt's device.

    Under a current rank (``tp.active``; ``params`` the rank's shards,
    ``prompt`` the rank's own rows) the cache holds the rank's rows
    (``init_cache``), so with ``cfg.cp_decode`` every decode step is the
    context-parallel one (``cp_attention.cp_available``), and each
    sampled token is the group root's, broadcast, so every rank feeds
    the same token."""
    model = get_model(cfg)
    tokens = prompt["tokens"]
    b, s = tokens.shape
    cache = model.init_cache(cfg, b, s + steps, device=tokens.device)
    logits, cache = model.prefill(params, prompt, cfg, cache)

    def sample(logits):
        tok = sample_tokens(logits[:, -1], generator=generator,
                            temperature=temperature)
        return tp.broadcast_from_root(tok.contiguous(), "tokens")[:, None]

    out = [sample(logits)]
    for i in range(steps - 1):
        logits, cache = model.decode_step(params, cache, out[-1], s + i,
                                          cfg)
        out.append(sample(logits))
    return torch.cat(out, dim=1)
