"""Shared-prefix KV cache: a radix tree over page-aligned token blocks —
the port's copy of ``repro/serve/prefix.py`` (pure host code).

N requests that open with the same system prompt should not hold N
physical copies of its KV. This module maps PROMPT PREFIXES to pages of
the engine's paged pool (serve/paging.py): the tree is keyed block-wise —
one edge per ``page_size``-token block, keyed by the exact token tuple —
so a lookup walks the request's context one full block at a time and
returns the pool pages that already hold that prefix's KV. The engine
adopts them (refcount += 1) instead of allocating and recomputing writes.

Why block sharing is EXACT: with causal attention, the K/V at position p
is a function of tokens 0..p only — a donor request whose context starts
with the same blocks computed bit-identical KV for those positions,
whatever its suffix was (padding is right-aligned and masked). Two archs
need a coarser key, supplied by the engine as a ``salt`` namespace that
prefixes every path through the tree:

  * enc-dec decoders cross-attend to the encoder output, so decoder KV
    depends on the FRAMES too — the engine salts with a digest of the
    request's frame embeddings (same audio + same prompt prefix shares);
  * MoE capacity routing makes token p's expert assignment depend on the
    whole sequence (capacity ~ total tokens), so block KV is only
    portable between IDENTICAL contexts — the engine salts with a digest
    of the full context, turning sharing into exact-duplicate dedup.

Lifetime: each registered block holds ONE cache reference on its page
(``allocator.ref``), so pages survive their last owner's retirement and a
later request with the same prefix still hits — a preempted victim's
re-prefill is cheap because its prefix pages are usually still resident.
Under pool pressure the engine evicts least-recently-matched leaves
(``evict_one``): only pages whose refcount is exactly the cache's own
reference are reclaimable, so sharing never steals a live request's
pages.

Partial-tail matching (``want_tail``) is the copy-on-write hook: when the
context ends mid-block, a registered block whose first tokens equal the
context's tail can back that last partial page too. The adopting request
will WRITE into that page at its first decode step, so the engine must
``allocator.cow`` + device-copy it first — see ServeEngine._grow_and_cow.

The cache deals only in page ids and token tuples, so it is blind to
the device the pool lives on; each engine owns its own pool and tree.

On the card, sharing is exact in bf16 too: the paged-attention kernel
gives a row the same bits whatever rows share its tile
(``csrc/paged_attention.cu``), so a row that reads a donor's pages
computes what it would have computed over its own.
"""
from __future__ import annotations

from itertools import count
from typing import Dict, Hashable, List, Optional, Sequence, Tuple


class _Node:
    __slots__ = ("key", "page", "parent", "children", "stamp")

    def __init__(self, key, page: int, parent: Optional["_Node"],
                 stamp: int):
        self.key = key                  # block token tuple (None for roots)
        self.page = page                # pool page holding this block's KV
        self.parent = parent
        self.children: Dict[tuple, _Node] = {}
        self.stamp = stamp              # LRU: last match/insert touch


class PrefixCache:
    """Radix tree of page-aligned token blocks -> refcounted pool pages."""

    def __init__(self, allocator, page_size: int):
        self.alloc = allocator
        self.page_size = page_size
        self._roots: Dict[Hashable, _Node] = {}
        self._clock = count()
        self.hit_blocks = 0            # blocks served from the cache
        self.miss_blocks = 0           # full blocks computed fresh
        self.tail_hits = 0             # partial-tail (CoW-bound) hits

    # -------------------------------------------------------------- sizing
    def __len__(self) -> int:
        """Registered blocks (= cache references held on the pool)."""
        return sum(self._count(r) for r in self._roots.values())

    def _count(self, node: _Node) -> int:
        return sum(1 + self._count(c) for c in node.children.values())

    def _blocks(self, tokens: Sequence[int]) -> List[tuple]:
        ps = self.page_size
        return [tuple(int(t) for t in tokens[i:i + ps])
                for i in range(0, len(tokens) - len(tokens) % ps, ps)]

    # ------------------------------------------------------------ matching
    def match(self, tokens: Sequence[int], *, salt: Hashable = None,
              want_tail: bool = False
              ) -> Tuple[List[int], Optional[int], int]:
        """Longest-prefix lookup for ``tokens`` under the ``salt``
        namespace. Returns ``(pages, tail_page, matched_tokens)``:
        ``pages`` are the pool pages backing the matched FULL blocks (in
        block order), ``tail_page`` (only with ``want_tail``) additionally
        backs the context's final partial block when some registered
        block STARTS with those tokens — adopting it obliges the caller
        to copy-on-write before writing into it. Matched nodes are
        LRU-touched; the hit/miss counters are the CALLER's to bump (on
        successful adoption — a backpressured admission re-matches every
        step and must not inflate them)."""
        node = self._roots.get(salt)
        pages: List[int] = []
        if node is None:
            return pages, None, 0
        stamp = next(self._clock)
        blocks = self._blocks(tokens)
        for key in blocks:
            child = node.children.get(key)
            if child is None:
                break
            child.stamp = stamp
            pages.append(child.page)
            node = child
        tail_page = None
        tail = tuple(int(t) for t in tokens[len(blocks) * self.page_size:])
        if want_tail and tail and len(pages) == len(blocks):
            for key, child in node.children.items():
                if key[:len(tail)] == tail:
                    child.stamp = stamp
                    tail_page = child.page
                    break
        return pages, tail_page, len(pages) * self.page_size

    # ----------------------------------------------------------- insertion
    def insert(self, tokens: Sequence[int], pages: Sequence[int], *,
               salt: Hashable = None) -> int:
        """Register the full blocks of ``tokens`` along one path, taking a
        cache reference on each newly registered page (``pages`` is the
        owner's block-ordered page list, shared head included). Blocks
        already registered keep their existing page — concurrent
        duplicates never fork the tree. Returns newly registered block
        count."""
        node = self._roots.get(salt)
        if node is None:
            node = self._roots[salt] = _Node(None, -1, None,
                                             next(self._clock))
        stamp = next(self._clock)
        added = 0
        for i, key in enumerate(self._blocks(tokens)):
            child = node.children.get(key)
            if child is None:
                self.alloc.ref(pages[i])
                child = _Node(key, pages[i], node, stamp)
                node.children[key] = child
                added += 1
            child.stamp = stamp
            node = child
        return added

    # ------------------------------------------------------------ eviction
    def _leaves(self) -> List[_Node]:
        out, stack = [], list(self._roots.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            elif n.parent is not None:         # skip empty roots
                out.append(n)
        return out

    def evictable_pages(self, keep: frozenset = frozenset()) -> int:
        """Blocks only the cache references (and outside ``keep``) —
        exactly what a full eviction sweep could free. Exact, not an upper
        bound: adoption always covers a root path (full blocks, then the
        tail), so an unreferenced node never has a referenced descendant
        blocking its turn as a leaf."""
        n = 0
        stack = list(self._roots.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if node.parent is not None and node.page not in keep \
                    and self.alloc.refcount(node.page) == 1:
                n += 1
        return n

    def evict_one(self, keep: frozenset = frozenset()) -> bool:
        """Drop the least-recently-matched UNREFERENCED leaf (a page whose
        only reference is the cache's own — evicting never steals a page
        some live request still reads) and release its page. ``keep``
        protects pages mid-adoption. Returns False when nothing is
        evictable."""
        best = None
        for leaf in self._leaves():
            if leaf.page in keep or self.alloc.refcount(leaf.page) != 1:
                continue
            if best is None or leaf.stamp < best.stamp:
                best = leaf
        if best is None:
            return False
        del best.parent.children[best.key]
        self.alloc.deref(best.page)
        return True

    def flush(self) -> int:
        """Evict every evictable block (refcount-1 pages only); blocks a
        live request still shares stay registered. Returns evicted
        count."""
        n = 0
        while self.evict_one():
            n += 1
        return n
