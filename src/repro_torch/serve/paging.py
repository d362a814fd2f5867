"""Host-side page allocator for the paged KV cache (vLLM-style block tables).

The device pool (``models/kvcache.init_paged_kv``) is a flat array of
fixed-size pages; WHICH pages belong to WHICH slot is pure bookkeeping, so
it lives here on the host as a free-list over page ids. The engine reserves
pages at admission (worst-case ``ceil(ctx_cap / page_size)`` up front, or
just the prompt + one decode page under lazy growth) and returns every
reference when the request retires or is preempted.

Pages are REFERENCE-COUNTED so the prefix cache (serve/prefix.py) can share
one physical copy of a common prompt prefix across N requests:

  * ``alloc(owner, n, shared=pages)`` adopts already-live pages as the head
    of the owner's reservation (refcount += 1 each, zero fresh pages spent)
    and draws fresh pages (refcount 1) for the remainder;
  * ``ref``/``deref`` are raw references for a cache that keeps pages
    resident after their last owner retires (deref to 0 frees the page);
  * ``cow(owner, block)`` is the copy-on-write step: when a writer is about
    to extend into a page it shares (refcount > 1), the allocator swaps a
    fresh private page into the owner's table at that block and drops one
    reference on the shared original. (The DEVICE copy of the page's
    contents is the engine's job — ``models/kvcache.copy_page``.)

Invariants (property-tested in tests/test_paged_allocator.py against a
reference model, plus the hypothesis-free twin in tests/test_serve_paged.py):

  * refcount conservation: every live page's refcount equals the number of
    owners listing it plus the raw ``ref()`` count; pages_in_use equals the
    number of UNIQUE live pages (free + unique-live == pool);
  * ``free(owner)`` drops one reference per owned page — a page returns to
    the free-list exactly when its last reference drops (no double-free);
  * after ``cow`` the writer holds a refcount-1 private page and every
    other holder still sees the original;
  * without sharing ops the legacy exclusive-ownership behaviour is
    unchanged: ``pages_in_use == sum(ceil(len_i / page_size))``, and
    ``alloc``/``extend`` fail (None) exactly when the free-list is shorter
    than the request — never by fragmentation, because pages are uniform.

``extend`` on an unknown owner raises ``KeyError`` (it is a lookup error,
not a value error — and must never mint a fresh owner entry).

``rollback(owner, n_tokens)`` is ``extend``'s inverse for speculative
decode: tail pages beyond ``ceil(n_tokens / page_size)`` are released
(one reference each) and the owner's token length drops — the engine
calls it when the verifier rejects drafted tokens whose pages were
reserved optimistically.

Page id 0 is conventionally the NULL page (scratch rows for inactive
slots and bucket padding); construct with ``first_page=1`` to keep it out
of circulation.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Dict, Hashable, Iterable, List, Optional, Sequence


def pages_for(n_tokens: int, page_size: int) -> int:
    """Pages needed to hold ``n_tokens`` (= ceil(n_tokens / page_size))."""
    if n_tokens < 0:
        raise ValueError(f"n_tokens must be >= 0, got {n_tokens}")
    return -(-n_tokens // page_size)


class PageAllocator:
    """Refcounted free-list allocator over ``num_pages`` uniform KV pages.

    Pure Python, O(pages moved) per call; owners are arbitrary hashable
    keys (the engine uses slot indices). A page may be listed by several
    owners (shared prefix) and/or held by raw ``ref()`` references (the
    prefix cache); it returns to the free-list when the last reference
    drops.
    """

    def __init__(self, num_pages: int, page_size: int, *,
                 first_page: int = 0):
        if num_pages < 1:
            raise ValueError(f"num_pages must be >= 1, got {num_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.num_pages = num_pages
        self.page_size = page_size
        self.first_page = first_page
        self._free: Deque[int] = deque(range(first_page,
                                             first_page + num_pages))
        self._owned: Dict[Hashable, List[int]] = {}
        self._len: Dict[Hashable, int] = {}
        self._ref: Dict[int, int] = {}        # live page -> reference count
        self._peak_owner = 0                  # high-water: pages/owner

    # ------------------------------------------------------------- queries
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        """UNIQUE live pages (a shared page counts once)."""
        return self.num_pages - len(self._free)

    def owners(self):
        return self._owned.keys()

    def pages_of(self, owner: Hashable) -> List[int]:
        return list(self._owned.get(owner, ()))

    def refcount(self, page: int) -> int:
        """References on a live page (0 for free pages)."""
        return self._ref.get(page, 0)

    def refcounts(self) -> Dict[int, int]:
        return dict(self._ref)

    def can_alloc(self, n_tokens: int) -> bool:
        return pages_for(n_tokens, self.page_size) <= len(self._free)

    @property
    def peak_owner_pages(self) -> int:
        """High-water mark of pages held by any SINGLE owner over the
        allocator's lifetime (monotone). This bounds how many page-table
        entries any slot has ever populated, so the engine's paged-
        attention gather only needs this many blocks — decode cost tracks
        occupancy, not the full table width (layers.paged_attention)."""
        return self._peak_owner

    # ----------------------------------------------------------- mutations
    def _take_fresh(self, n: int) -> List[int]:
        fresh = [self._free.popleft() for _ in range(n)]
        for p in fresh:
            self._ref[p] = 1
        return fresh

    def _drop(self, page: int):
        n = self._ref[page] - 1
        if n == 0:
            del self._ref[page]
            self._free.append(page)
        else:
            self._ref[page] = n

    def alloc(self, owner: Hashable, n_tokens: int, *,
              shared: Sequence[int] = ()) -> Optional[List[int]]:
        """Reserve pages covering ``n_tokens`` for ``owner``: adopt the
        ``shared`` pages (already-live pool pages, e.g. a prefix-cache hit,
        in block order) as the head of the reservation and draw fresh
        pages for the rest. Returns the full block-ordered page-id list,
        or None when the free-list cannot supply the fresh remainder (no
        references are taken — the caller keeps the request queued:
        admission backpressure, not an error)."""
        if owner in self._owned:
            raise ValueError(f"owner {owner!r} already holds pages; "
                             "free() it before re-allocating")
        shared = list(shared)
        for p in shared:
            if p not in self._ref:
                raise ValueError(f"shared page {p} is not live")
        need = pages_for(n_tokens, self.page_size) - len(shared)
        if need < 0:
            raise ValueError(
                f"owner {owner!r}: {len(shared)} shared pages exceed the "
                f"{pages_for(n_tokens, self.page_size)}-page reservation "
                f"for {n_tokens} tokens")
        if need > len(self._free):
            return None
        for p in shared:
            self._ref[p] += 1
        pages = shared + self._take_fresh(need)
        self._owned[owner] = pages
        self._len[owner] = n_tokens
        self._peak_owner = max(self._peak_owner, len(pages))
        return list(pages)

    def extend(self, owner: Hashable, n_tokens: int) -> Optional[List[int]]:
        """Grow ``owner``'s reservation to cover ``n_tokens`` total.
        Returns the NEWLY added pages ([] if already covered), or None if
        the free-list cannot supply them (reservation unchanged). Raises
        KeyError for an owner that holds no pages — extend must never mint
        a fresh owner entry."""
        if owner not in self._owned:
            raise KeyError(f"owner {owner!r} holds no pages")
        if n_tokens < self._len[owner]:
            raise ValueError(
                f"owner {owner!r}: cannot shrink {self._len[owner]} -> "
                f"{n_tokens} tokens (pages are only released by free())")
        need = pages_for(n_tokens, self.page_size) - len(self._owned[owner])
        if need > len(self._free):
            return None
        fresh = self._take_fresh(max(need, 0))
        self._owned[owner].extend(fresh)
        self._len[owner] = n_tokens
        self._peak_owner = max(self._peak_owner, len(self._owned[owner]))
        return fresh

    def rollback(self, owner: Hashable, n_tokens: int) -> List[int]:
        """Shrink ``owner``'s reservation back to cover ``n_tokens``
        total — the speculative-decode rejection path: draft pages
        reserved for tokens the verifier rejected are returned, tail
        first. Drops one reference per released tail page (a shared
        page stays live for its other holders) and returns the pages
        removed from the owner's table ([] when the reservation already
        fits) so the engine can null their page-table entries. Unlike
        ``free`` this never releases pages the accepted context still
        needs; unlike ``extend`` it may lower the owner's token length
        (``extend``'s no-shrink rule guards against accidental loss —
        rollback IS the deliberate loss). ``peak_owner_pages`` stays
        monotone: the bounded-gather bucket never shrinks mid-decode."""
        if owner not in self._owned:
            raise KeyError(f"owner {owner!r} holds no pages")
        if n_tokens > self._len[owner]:
            raise ValueError(
                f"owner {owner!r}: rollback to {n_tokens} tokens exceeds "
                f"the {self._len[owner]}-token reservation (use extend)")
        pages = self._owned[owner]
        keep = pages_for(n_tokens, self.page_size)
        dropped = pages[keep:]
        del pages[keep:]
        for p in dropped:
            self._drop(p)
        self._len[owner] = n_tokens
        return dropped

    def cow(self, owner: Hashable, block: int) -> Optional[int]:
        """Copy-on-write: give ``owner`` a PRIVATE page at table index
        ``block``. If the page there is unshared (refcount 1) it is
        returned as-is; otherwise a fresh page replaces it in the owner's
        list (refcount 1) and one reference is dropped from the shared
        original. Returns None when no fresh page is free (owner
        unchanged). The caller copies the page CONTENTS on device."""
        if owner not in self._owned:
            raise KeyError(f"owner {owner!r} holds no pages")
        pages = self._owned[owner]
        if not 0 <= block < len(pages):
            raise ValueError(f"owner {owner!r}: block {block} outside its "
                             f"{len(pages)}-page table")
        old = pages[block]
        if self._ref[old] == 1:
            return old
        if not self._free:
            return None
        [new] = self._take_fresh(1)
        self._ref[old] -= 1          # shared: never drops to 0 here
        pages[block] = new
        return new

    def ref(self, page: int):
        """Take a raw reference on a live page (the prefix cache pinning a
        registered block)."""
        if page not in self._ref:
            raise KeyError(f"page {page} is not live")
        self._ref[page] += 1

    def deref(self, page: int):
        """Drop a raw reference; the page returns to the free-list when
        its last reference drops."""
        if page not in self._ref:
            raise KeyError(f"page {page} is not live")
        self._drop(page)

    def free(self, owner: Hashable) -> List[int]:
        """Drop one reference on each of ``owner``'s pages (shared pages
        stay live for their other holders). Returns the owner's page
        list."""
        pages = self._owned.pop(owner, None)
        if pages is None:
            raise ValueError(f"owner {owner!r} holds no pages")
        del self._len[owner]
        for p in pages:
            self._drop(p)
        return pages
