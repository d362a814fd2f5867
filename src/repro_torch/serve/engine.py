"""Serving engine: continuous batching over ONE mixed token-slot step per
engine step — the port of the paged, mixed path of
``repro/serve/engine.py``.

The KV cache is a flat pool of ``page_size``-token pages shared by every
slot plus a per-slot page table (models/kvcache.py); which pages a slot
owns is host bookkeeping (serve/paging.py). Each step runs one device
program over a ``chunk_tokens``-row batch: every decoding slot's next
token first, then prefill CHUNKS of admitted requests (serve/step.py::
pack_token_budget), then pads. Each row carries its context position, its
page-table row, whether to sample from it, and whether its K/V write goes
to the null page. ``decode_step`` scatters every row's K/V before any row
attends, so chunked prefill is exact: greedy output equals the JAX
engine's.

The page table handed to the program is clipped to the power-of-two
bucket of the live page high-water mark (serve/step.py::page_bucket), so
attention cost tracks occupancy, not ``max_len``. The reference counts
jit traces; PyTorch runs eagerly, so ``stats["decode_traces"]`` counts
the distinct ``(chunk_tokens, page bucket)`` shapes the program has run
at — the same bounded-shape invariant.

The device decides the attention and MLP path: CUDA runs the port's
hand-written kernels, the CPU their plain versions
(``stats["decode_backend"]`` reads ``"kernel"`` or ``"plain"``).

Not ported yet, each raising ``NotImplementedError`` naming its
ROADMAP.md item: prefix sharing, lazy growth / CoW / preemption, other
schedulers and deadlines, speculative decode, the legacy split path and
the dense layout, TP/DP meshes, frames/images and the non-dense families.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.models import kvcache, transformer
from repro_torch.serve.paging import PageAllocator, pages_for
from repro_torch.serve.sampling import sample_tokens
from repro_torch.serve.scheduler import FifoLeastProgress
from repro_torch.serve.step import pack_token_budget, page_bucket
from repro_torch.serve.tracing import (NULL_STEP, Tracer, chrome_trace,
                                       export_chrome_trace)


def _todo(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md {item})")


@dataclass
class Request:
    """One request's lifecycle record; ``run()`` returns these.
    ``done=False`` marks a request cut by ``max_steps`` (partial or
    empty ``out``)."""
    rid: int
    prompt: np.ndarray                 # (len,) int32
    max_new: int
    out: List[int] = field(default_factory=list)
    done: bool = False
    priority: int = 0                  # scheduler hint, ignored by FIFO
    # host timestamp of the FIRST generated token
    first_tok_t: Optional[float] = field(default=None, repr=False)


class ServeEngine:
    def __init__(self, cfg, params, *, slots: int = 4, max_len: int = 256,
                 eos_id: Optional[int] = None, temperature: float = 0.0,
                 seed: int = 0, paged: Optional[bool] = None,
                 page_size: int = 16, kv_pages: Optional[int] = None,
                 prefix_cache: bool = False, lazy: bool = False,
                 scheduler=None, mesh=None, mixed: Optional[bool] = None,
                 chunk_tokens: int = 256, spec=None, tracer=None,
                 trace_level: int = 1, device=None):
        if cfg.arch_type != "dense" or cfg.is_moe:
            raise _todo(f"serving the {cfg.arch_type} family",
                        "Queue 1 item 10")
        if cfg.sliding_window > 0:
            raise _todo("the sliding-window ring cache", "Queue 1 item 10")
        if paged is False:
            raise _todo("the dense KV layout (paged=False)",
                        "Queue 1 item 5(d)")
        if mixed is False:
            raise _todo("the legacy split prefill/decode path (mixed=False)",
                        "Queue 1 item 5(d)")
        if prefix_cache:
            raise _todo("prefix_cache", "Queue 1 item 5(b)")
        if lazy:
            raise _todo("lazy page growth, CoW and preemption",
                        "Queue 1 item 5(b)")
        if scheduler is not None and type(scheduler) is not FifoLeastProgress:
            raise _todo("scheduler= other than the default",
                        "Queue 1 item 5(c)")
        if spec is not None:
            raise _todo("speculative decode (spec=)", "Queue 1 item 7")
        if mesh is not None:
            raise _todo("tp/dp meshes (mesh=)", "Queue 1 item 11")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if chunk_tokens < max(slots, 1):
            raise ValueError(
                f"chunk_tokens ({chunk_tokens}) must be >= slots "
                f"({slots}): every active slot's decode token is "
                "reserved in the budget before any prefill chunk")
        self.cfg, self.params = cfg, params
        self.device = torch.device(device) if device is not None \
            else params["embed"].device
        self.slots = slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.temperature = temperature
        self.page_size = page_size
        self.chunk_tokens = int(chunk_tokens)
        self.queue: Deque[Request] = deque()
        self.active: List[Optional[Request]] = [None] * slots
        self.finished: Dict[int, Request] = {}
        backend = "kernel" if self.device.type == "cuda" else "plain"
        # the reference's stats keys of the ported path (prefill_traces
        # stays 0: no separate prefill program); each other key comes with
        # the slice that ports its feature
        self.stats = {"decode_steps": 0, "decode_traces": 0,
                      "prefills": 0, "prefill_traces": 0,
                      "pages_in_use": 0, "peak_pages": 0,
                      "step_count": 0, "decode_tokens": 0,
                      "wall_time_s": 0.0, "tokens_per_s_ewma": 0.0,
                      "prefill_chunk_tokens": 0, "decode_slot_steps": 0,
                      # device program runs (decode_steps counts only
                      # those that carried a decode row)
                      "mixed_steps": 0,
                      "decode_backend": backend}
        self.tracer = tracer if tracer is not None \
            else Tracer(level=trace_level)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._sched = scheduler if scheduler is not None \
            else FifoLeastProgress()
        self._pos = np.zeros(slots, np.int64)    # host mirror: tokens in ctx
        self._last = np.zeros(slots, np.int64)   # host mirror: last token
        # the paged pool; page 0 is the null page (padding / inactive)
        pps = pages_for(max_len, page_size)      # table width: blocks/slot
        self.kv_pages = kv_pages if kv_pages is not None else slots * pps
        if self.kv_pages < 1:
            raise ValueError(f"kv_pages must be >= 1, got {self.kv_pages}")
        self._cache = {"kv": kvcache.init_paged_kv(
            cfg.num_layers, self.kv_pages + 1, page_size, cfg.num_kv_heads,
            cfg.head_dim, getattr(torch, cfg.dtype), self.device)}
        # the DEVICE page table is clipped to the power-of-two bucket of
        # the page high-water mark (_sync_ptab); the host mirror is full
        self._pps = pps
        self._gather = 1
        self._hw_blocks = 1
        self._ptab = np.zeros((slots, pps), np.int64)
        self._ptab_dirty = True
        self._alloc = PageAllocator(self.kv_pages, page_size, first_page=1)
        # mid-prefill slot table: slot -> {ctx, n, cursor, seq}
        self._pf: Dict[int, dict] = {}
        self._admit_seq = 0
        self._shapes = set()          # distinct (T, bucket) program shapes
        #: logits (chunk_tokens, 1, V) of the last step's program
        self.last_logits = None
        self._sync_ptab()

    # ------------------------------------------------------------ memory
    def kv_bytes(self) -> int:
        """Device bytes of the resident KV pool (allocated up front)."""
        return sum(t.numel() * t.element_size()
                   for t in self._cache["kv"].values())

    # -------------------------------------------------------- the program
    def _mixed_fn(self, tokens, pos, slot, active, wnull):
        """ONE device program for a mixed token-slot batch of T =
        ``chunk_tokens`` rows: decode tokens, prefill-chunk tokens and
        pads, each with its context position, page-table row, sample
        flag, and null-page write redirect (padding rows). Returns the
        sampled token per row (0 where not active)."""
        ptab_rows = self._cache["ptab"][slot]          # (T, bucket)
        view = {"kv": self._cache["kv"], "ptab": ptab_rows,
                "wtab": torch.where(wnull[:, None],
                                    torch.zeros_like(ptab_rows), ptab_rows)}
        logits, _ = transformer.decode_step(self.params, view, tokens, pos,
                                            self.cfg)
        self.last_logits = logits
        tok = sample_tokens(logits[:, -1], generator=self._gen,
                            temperature=self.temperature)
        return torch.where(active, tok, torch.zeros_like(tok))

    # --------------------------------------------------------- scheduling
    def submit(self, rid: int, prompt: np.ndarray, max_new: int, *,
               frames: Optional[np.ndarray] = None,
               images: Optional[np.ndarray] = None, priority: int = 0,
               deadline_s: Optional[float] = None):
        """Queue a request. Rejects what the engine can NEVER hold —
        prompts at/over ``max_len``, and requests whose worst-case pages
        exceed the whole pool — instead of deadlocking the FIFO head.
        Returns the LIVE Request record (``out`` grows as it decodes)."""
        if frames is not None or images is not None:
            raise _todo("frames=/images= requests (enc-dec and VLM)",
                        "Queue 1 item 10")
        if deadline_s is not None:
            raise _todo("deadline_s", "Queue 1 item 5(c)")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError(f"request {rid}: empty prompt")
        if prompt.size >= self.max_len:
            raise ValueError(
                f"request {rid}: prompt length {prompt.size} >= max_len "
                f"{self.max_len}; the longest servable prompt is "
                f"{self.max_len - 1} tokens")
        if max_new < 1:
            raise ValueError(f"request {rid}: max_new must be >= 1")
        cap = min(prompt.size + max_new - 1, self.max_len)
        worst = pages_for(cap, self.page_size)
        if worst > self.kv_pages:
            raise ValueError(
                f"request {rid}: worst-case context needs {worst} KV "
                f"pages ({self.page_size} tokens each) but the pool "
                f"holds {self.kv_pages}; raise kv_pages or lower "
                f"prompt+max_new")
        # pre-book the worst case in the bounded-gather high-water mark
        self._hw_blocks = max(self._hw_blocks, worst)
        req = Request(rid, prompt, int(max_new), priority=int(priority))
        self.queue.append(req)
        explain = getattr(self._sched, "explain", None)
        self.tracer.req_event(
            rid, "submitted", prompt_tokens=int(prompt.size),
            max_new=int(max_new), queue_depth=len(self.queue),
            **(explain(req) if explain is not None else {}))
        return req

    def _free_slot(self) -> Optional[int]:
        for s in range(self.slots):
            if self.active[s] is None:
                return s
        return None

    # ------------------------------------------------- paged bookkeeping
    def _sync_ptab(self):
        """Refresh the DEVICE page table from the host mirror, clipped to
        the power-of-two bucket of the page high-water mark (the max of
        the allocator's per-owner peak and every admitted request's
        worst case, pre-booked at submit)."""
        w = page_bucket(max(1, self._hw_blocks,
                            self._alloc.peak_owner_pages), cap=self._pps)
        if w != self._gather:
            self._gather = w
            self._ptab_dirty = True
        if self._ptab_dirty:
            self._cache["ptab"] = torch.from_numpy(
                np.ascontiguousarray(self._ptab[:, :w], np.int32)).to(
                self.device)
            self._ptab_dirty = False

    def _note_pool(self):
        used = self._alloc.pages_in_use
        self.stats["pages_in_use"] = used
        if used > self.stats["peak_pages"]:
            self.stats["peak_pages"] = used

    def _place_mixed(self, s: int, req: Request, ctx: np.ndarray):
        """Reserve slot ``s``'s worst-case pages. Returns the
        block-ordered page ids, or None on backpressure."""
        reserve = min(len(ctx) + req.max_new - len(req.out) - 1,
                      self.max_len)
        got = self._alloc.alloc(s, reserve)
        if got is not None:
            self._note_pool()
        return got

    def _admit_mixed(self):
        """Place pages and ENQUEUE the prefill work (no device call: the
        step drains it chunk by chunk). The slot is active at once; its
        first token is sampled on the chunk holding the last prompt
        position. Head-of-line: when the scheduler's pick cannot be
        placed, nothing is."""
        while True:
            qi = self._sched.next_index(self.queue)
            if qi is None:
                return
            s = self._free_slot()
            if s is None:
                return
            req = self.queue[qi]
            ctx = req.prompt
            got = self._place_mixed(s, req, ctx)
            if got is None:
                return
            self._ptab[s] = 0
            self._ptab[s, :len(got)] = got
            self._ptab_dirty = True
            del self.queue[qi]
            self.active[s] = req
            self._pos[s] = 0
            self._last[s] = 0
            self.tracer.req_event(req.rid, "admitted", slot=s,
                                  ctx_tokens=len(ctx), covered=0,
                                  resumed=False)
            self._pf[s] = {"ctx": ctx, "n": len(ctx), "cursor": 0,
                           "seq": self._admit_seq}
            self._admit_seq += 1

    def _release_pages(self, s: int):
        """Return slot ``s``'s pages and point its table row at the null
        page."""
        self._alloc.free(s)
        self._ptab[s] = 0
        self._ptab_dirty = True
        self._note_pool()

    def _retire(self, s: int):
        req = self.active[s]
        req.done = True
        self.finished[req.rid] = req
        self.tracer.finish_request(req.rid, "completed",
                                   tokens=len(req.out))
        self.active[s] = None
        self._release_pages(s)

    # -------------------------------------------------------------- serve
    def step(self) -> int:
        """One MIXED token-slot step: admit into free slots (pages only),
        fill the ``chunk_tokens`` budget with every decoding slot's next
        token FIRST and prefill chunks after (admission order), and run
        the whole batch as ONE device program. Admission runs again at
        the END so a request finishing on its prefill token frees its slot
        for the same-step queue. Returns the tokens produced."""
        t0 = time.perf_counter()
        before = self.stats["decode_tokens"]
        tr = self.tracer.begin_step(self.stats["step_count"])
        self._admit_mixed()
        tr.lap("bookkeeping")
        decode_slots = [s for s in range(self.slots)
                        if self.active[s] is not None and s not in self._pf]
        tr.lap("draft")
        items = sorted(self._pf.items(), key=lambda kv: kv[1]["seq"])
        allot = pack_token_budget(
            self.chunk_tokens, len(decode_slots),
            [{"slot": s, "cursor": st["cursor"], "n": st["n"]}
             for s, st in items])
        if not decode_slots and not allot:
            self._admit_mixed()
            return self._finish_step(t0, before, tr)
        T = self.chunk_tokens
        # rows: tokens, pos, slot, active, wnull — one host array, one copy
        meta = np.zeros((5, T), np.int32)
        meta[4] = 1                       # pads write to the null page
        r = 0
        for s in decode_slots:
            meta[:, r] = (self._last[s], self._pos[s], s, 1, 0)
            r += 1
        emit_row: Dict[int, int] = {}
        for s, start, count in allot:
            st = self._pf[s]
            ctx, last = st["ctx"], st["n"] - 1
            meta[0, r:r + count] = ctx[start:start + count]
            meta[1, r:r + count] = np.arange(start, start + count)
            meta[2, r:r + count] = s
            meta[4, r:r + count] = 0
            if start <= last < start + count:
                meta[3, r + last - start] = 1
                emit_row[s] = r + last - start
            r += count
        self._sync_ptab()
        self._shapes.add((T, self._gather))
        self.stats["decode_traces"] = len(self._shapes)
        tr.lap("pack")
        dev = torch.from_numpy(meta).to(self.device)
        tok = self._mixed_fn(dev[0][:, None], dev[1], dev[2].long(),
                             dev[3].bool(), dev[4].bool())
        tr.lap("dispatch")
        toks = tok.cpu().numpy()
        tr.lap("sync")
        self.stats["mixed_steps"] += 1
        if decode_slots:
            self.stats["decode_steps"] += 1
            self.stats["decode_slot_steps"] += len(decode_slots)
        for r, s in enumerate(decode_slots):
            req = self.active[s]
            t = int(toks[r])
            req.out.append(t)
            self._pos[s] += 1
            self._last[s] = t
            self.stats["decode_tokens"] += 1
            # count BEFORE a possible retire: finish_request seals the span
            self.tracer.req_tokens(req.rid, 1)
            self.tracer.req_detail(req.rid, "decode", slot=s, tokens=1,
                                   drafted=0, accepted=0)
            tr.note_decode(s, req.rid, 1, drafted=0, accepted=0)
            hit_eos = self.eos_id is not None and t == self.eos_id
            if len(req.out) >= req.max_new or hit_eos or \
                    self._pos[s] >= self.max_len:
                self._retire(s)
        for s, start, count in allot:
            st = self._pf[s]
            st["cursor"] = start + count
            self.stats["prefill_chunk_tokens"] += count
            req = self.active[s]
            tr.note_chunk(s, req.rid, start, count)
            self.tracer.req_chunk_tokens(req.rid, count)
            self.tracer.req_detail(req.rid, "prefill_chunk", slot=s,
                                   start=start, count=count)
            if st["cursor"] > st["n"] - 1:
                # final chunk ran the last prompt position: emit the first
                # token and flip the slot to decoding
                del self._pf[s]
                t = int(toks[emit_row[s]])
                self.stats["prefills"] += 1
                self.stats["decode_tokens"] += 1
                req.out.append(t)
                self.tracer.req_tokens(req.rid, 1)
                if req.first_tok_t is None:
                    req.first_tok_t = time.monotonic()
                    self.tracer.req_event(req.rid, "first_token",
                                          prefill_tokens=int(st["n"]))
                self._pos[s] = st["n"]
                self._last[s] = t
                hit_eos = self.eos_id is not None and t == self.eos_id
                if len(req.out) >= req.max_new or hit_eos or \
                        st["n"] >= self.max_len:
                    self._retire(s)
        self._admit_mixed()
        return self._finish_step(t0, before, tr)

    def _finish_step(self, t0: float, before: int, tr=NULL_STEP) -> int:
        """Step epilogue: token count, timing telemetry and the step's
        trace record (residual time folds into bookkeeping)."""
        produced = self.stats["decode_tokens"] - before
        tr.lap("bookkeeping")
        self.tracer.end_step(tr, produced)
        dt = time.perf_counter() - t0
        self.stats["step_count"] += 1
        self.stats["wall_time_s"] += dt
        if produced and dt > 0:
            rate = produced / dt
            ewma = self.stats["tokens_per_s_ewma"]
            self.stats["tokens_per_s_ewma"] = \
                rate if ewma <= 0 else 0.8 * ewma + 0.2 * rate
        return produced

    # ---- observability surface (delegates to the tracer) -------------

    def trace(self) -> dict:
        """Chrome ``trace_event`` JSON object for this engine's tracer."""
        return chrome_trace([self.tracer])

    def export_trace(self, path: str) -> dict:
        """Write the Chrome/Perfetto trace JSON to ``path``."""
        return export_chrome_trace(path, [self.tracer])

    def reset_stats(self):
        """Zero the telemetry counters (steady-state measurement) EXCEPT
        ``decode_traces``/``prefill_traces`` — program-shape counts over
        the engine's lifetime — and the backend name.
        Pool gauges restart from the current occupancy."""
        keep = ("decode_traces", "prefill_traces", "decode_backend")
        for k, v in self.stats.items():
            if k not in keep:
                self.stats[k] = 0.0 if isinstance(v, float) else 0
        self._note_pool()
        self.stats["peak_pages"] = self.stats["pages_in_use"]

    def run(self, max_steps: int = 10_000) -> Dict[int, Request]:
        """Serve until the queue and slot table drain (or ``max_steps``);
        returns every submitted request's record."""
        steps = 0
        while self.busy() and steps < max_steps:
            self.step()
            steps += 1
        return self.results()

    def busy(self) -> bool:
        """True while any request is queued or in a slot."""
        return bool(self.queue) or any(r is not None for r in self.active)

    def results(self) -> Dict[int, Request]:
        """Every submitted request's record so far: finished, active
        (partial ``out``) and queued (``out == []``)."""
        results = dict(self.finished)
        for req in list(self.active) + list(self.queue):
            if req is not None:
                results[req.rid] = req
        return results
