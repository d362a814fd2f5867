"""Serving engine: continuous batching over a slot table — the port of
the paged mixed path and the legacy split path of
``repro/serve/engine.py``. The family and the layout decide the path, by
the reference's rules: full-attention dense and MoE decoders and the
enc-dec audio family take the paged pool and ONE mixed token-slot step
per engine step by default; the split path serves the rest — those
models with ``mixed=False`` (on the pool) or ``paged=False``,
sliding-window configs (on the dense ring), the SSM family (not pageable:
its cache is a constant-size recurrent state), the hybrid (its Mamba
states beside the shared block's dense K/V rows, not pageable either, as
in the reference) and the VLM (its image K/V a separate block a slot:
the reference serves it on the dense layout only).

**Mixed path (dense and MoE decoders, enc-dec audio).** The KV cache is
a flat pool of ``page_size``-token pages shared by every slot plus a
per-slot page table (models/kvcache.py); which pages a slot owns is
host bookkeeping (serve/paging.py). Each step runs one device program over a
``chunk_tokens``-row batch: every decoding slot's next token first, then
prefill CHUNKS of admitted requests (serve/step.py::pack_token_budget),
then pads. Each row carries its context position, its
page-table row, whether to sample from it, and whether its K/V write goes
to the null page. ``decode_step`` scatters every row's K/V before any row
attends, so chunked prefill is exact: greedy output equals the JAX
engine's. An enc-dec request's frames run through the encoder as a
program of their own at admission (a resumed one's too), which parks
each decoder layer's cross K/V in the slot's dense ``(L, slots,
encoder_ctx, Hkv, D)`` block; ``stats["encode_traces"]`` counts the
distinct frame shapes it has run (one a config).

The page table handed to the program is clipped to the power-of-two
bucket of the live page high-water mark (serve/step.py::page_bucket), so
attention cost tracks occupancy, not ``max_len``. The reference counts
jit traces; PyTorch runs eagerly, so ``stats["decode_traces"]`` counts
the distinct ``(chunk_tokens, page bucket)`` shapes the program has run
at — the same bounded-shape invariant.

**Split path** (``mixed=False``: the only path of the SSM family, the
hybrid and the VLM, and the legacy path of dense and MoE decoders). Each
admitted request is prefilled alone by its own device program, its first token
sampled and its fresh cache stored; then ONE batched decode advances
every slot per step (inactive rows run too and are overwritten at their
next prefill, as in the reference). Dense decoders pad the prompt to
``prefill_bucket(n, cap=window)`` and gather the logits at ``last_pos =
n - 1``; an enc-dec prefill takes the request's frames, runs the encoder
and stores the cross K/V in the slot's block (both layouts), a VLM
prefill takes the request's images and stores each cross layer's image
K/V in the slot's block; on the
dense layout the prefill writes row ``slot`` of every cache leaf in
place, on the paged layout it fills a scratch cache of
whole pages that ``scatter_prefill_pages`` writes through the slot's
pages (bucket padding to the null page). MoE decoders prefill at the
exact length (capacity routing is pad-sensitive), on either layout, and
so do enc-dec decoders and the VLM (the reference's prefill gathers no
``last_pos``).
The
SSM family and the hybrid prefill at the exact length (the recurrence is
pad-sensitive) and keep their states (and the hybrid its K/V rows, a
ring of the window on sliding-window configs) in the dense layout.
``stats["prefill_traces"]`` counts the distinct padded prefill lengths
run and ``stats["decode_traces"]`` the distinct decode shapes (one, or
one a page bucket) — the reference's jit-trace counts. The reference's
chunked-SSD precondition holds: a prompt longer than ``ssm_chunk`` that
is not a multiple of it raises ``ValueError`` inside its prefill, after
it left the queue, where the reference's assert fires.

Layouts, by the reference's rules: the paged pool for full-attention
dense and MoE decoders (``PAGEABLE_ARCHS``, no sliding window) unless
``paged=False``; the dense per-slot layout otherwise, which is a ring of
``sliding_window`` rows on sliding-window configs.

**MoE caveat** (the reference's): capacity-based expert routing couples
the rows of one program, so an MoE decoder's batched output can differ
from single-request decode. Every row of a program is routed and
consumes expert capacity exactly as in the reference — the mixed step's
pads (token 0, writing to the null page) and the split path's inactive
slots included — so the port's streams equal the JAX engine's on the
same inputs. MoE prompts are not bucketed (pad tokens would take
capacity: the prefill runs at the exact length), and the prefix cache
keys an MoE block on a digest of the WHOLE context (``_salt``): its KV
is portable only between identical sequences. A preempted MoE request
re-prefills its whole context under prefill capacity, where the
uninterrupted run routed its tail token by token.

The device decides the kernel path: CUDA runs the port's hand-written
kernels (paged attention on the paged layout, the fused MLP in every
dense-decoder program and in every application of the hybrid's shared
block — never in an MoE layer, whose experts are batched matmuls as in
the reference — flash attention in every dense or MoE split prefill and
every hybrid prefill, flash attention in every enc-dec encoder run and
split prefill, flash attention in every self layer of a VLM prefill and
the fused MLP in every VLM layer, self or cross, of every program, the
SSD scan in every Mamba layer of an SSM or hybrid prefill), the CPU
their plain versions
(``stats["decode_backend"]`` reads ``"kernel"`` or ``"plain"``). On a
CUDA device an engine refuses, at construction, shapes a kernel of its
path cannot take (each kernel's ``kernel_limits``: paged attention on
the paged layout, flash attention on the dense, MoE, hybrid and VLM
split paths and on every enc-dec path, the fused MLP on every dense,
hybrid and VLM path, the SSD scan on every SSM and hybrid path); nothing
falls back to a plain version there.

**Prefix sharing, lazy growth, copy-on-write and preemption** (the
paged pool, both paths), as the reference's: ``prefix_cache=True`` maps
page-aligned prompt blocks to refcounted pool pages through a radix tree
(serve/prefix.py), so requests with a common prefix hold one copy and
skip its prefill (the mixed step also adopts pages a donor is still
prefilling, and registers blocks as cursors pass them); ``lazy=True``
reserves the context plus its first decode page at admission and grows
the reservation as cursors cross pages, evicting cold prefix blocks and
then PREEMPTING the scheduler's victim when the pool runs dry (the
victim is requeued with its output and resumes by re-prefilling
``prompt + out``); a partial-tail prefix hit is copied on the first
decode write (``kvcache.copy_page``). ``scheduler=`` takes any policy
object (``next_index``, ``prefill_key``, ``pick_victim``, ``requeue``,
``explain``); ``submit(deadline_s=)`` admits nearest deadline first and
expires a request still queued past it; ``abort_event`` (a
``threading.Event``) makes a mixed step return before it launches its
program. Greedy streams stay exactly those of the JAX engine: on the
card in bf16 too, because a paged row's bits do not depend on the rows
beside it (kernels/paged_attention.py).

**Speculative decode** (``spec=SpecConfig(...)``, the mixed step and
greedy sampling only): each decoding slot's base row is followed by up to
``k`` drafted tokens at consecutive positions (serve/speculative.py), all
verified in the same program; the longest prefix matching the verifier's
argmax chain is accepted plus one bonus token, and under lazy growth the
draft pages past the accepted cursor go back through
``PageAllocator.rollback``. Greedy streams equal the non-speculative ones
token for token, and the program set stays one per (``chunk_tokens``,
page bucket).

**Tensor-parallel serving** (``mesh=``, a ("data", "model") = (1, tp)
``DeviceMesh``; ``Session.serve(tp=)`` builds it), for every family:
dense and MoE decoders, the enc-dec audio family, the SSM family, the
hybrid and the VLM. The reference runs its programs
GSPMD-sharded from one controller; the port runs one process a rank
(``torchrun``), each with this engine over its own shards
(``core/tp.py``): the Megatron layout of ``core/sharding.py`` with heads
kept whole — Hq/tp query heads, Hkv/tp K/V heads of every page (all Hkv,
replicated, where they do not divide; the dense rows of a dense or MoE
decoder then hold the rank's sequence slice of every row where the
rows' length divides tp, decoded by the context-parallel branch of
``transformer.decode_step``, as the reference's ``cache_pspecs`` lays
them out), d_ff/tp of the MLP, E/tp of an MoE
layer's experts (models/moe.py), H/tp whole heads of a Mamba2 block
(its ``in_proj`` and conv by head with all of B and C, its states and
conv tails the rank's: models/ssm.py) and V/tp of the vocabulary — and one
all-reduce after ``wo``, one after ``w_down`` (an MoE layer: one over its
experts' slots, ``"moe_out"``; a Mamba layer: one after ``out_proj``,
``"ssm_out"``, and one for its gated norm, ``"ssm_norm"``), one for the
embedding and one to
assemble the logits. An enc-dec engine runs each admission's encoder on
the rank's shards too, and its cross K/V blocks hold the rank's heads; a
VLM's cross layers run on the rank's heads and MLP block like its self
layers (two sums each), its image K/V blocks the rank's heads, or its
slice of the image positions with every head where Hkv does not divide
tp (``vlm.decode_step`` then attends context-parallel).
The kernels run at the rank's shapes, checked at construction. Every
rank runs the same host engine (scheduler, allocator, prefix cache) on
the same submissions, so pages, prefix hits, CoW, preemption and
speculative decode match across ranks; what could
still diverge is fixed by rank 0: the sampled tokens (broadcast after
each program) and the clock every deadline decision reads (broadcast
each step and at ``submit(deadline_s=)``). Before each program the ranks
compare a checksum of what they packed (one all-reduce of ``(c, -c)``
with MAX) and raise if it differs. ``kv_bytes`` stays global;
``per_device_kv_bytes`` is one rank's share. On a mesh with ``data`` > 1
each row of the mesh is one replica: this engine serves its row, with
its collectives on the row's "model" group and its root the row's
first rank (serve/parallel.py's ``ReplicaRouter`` routes across the
rows); on a ("pod", "data", "model") mesh each ("pod", "data")
coordinate is such a row, as the reference's rules put the batch over
("pod", "data"). The online driver
(serve/driver.py) serves such an engine from rank 0, broadcasting its
host events to every rank before each step; under it ``abort_event`` is
the pass's copy of the abort, the same on every rank. An MoE splits over
"model" by the ``strategy``: its experts (``expert_parallel``, the
default) or each expert's d_ff (``expert_parallel=False``;
``models/moe.py``). A mesh with an axis other than "pod", "data" and
"model" raises ``ValueError``.
"""
from __future__ import annotations

import hashlib
import time
import zlib
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import tp
from repro_torch.core.strategy import Strategy, mesh_axes, serving
from repro_torch.kernels import (flash_attention, fused_mlp,
                                 paged_attention, ssd_scan)
from repro_torch.models import get_model, kvcache, transformer
from repro_torch.params import full_shapes
from repro_torch.serve.paging import PageAllocator, pages_for
from repro_torch.serve.prefix import PrefixCache
from repro_torch.serve.sampling import sample_tokens
from repro_torch.serve.scheduler import FifoLeastProgress
from repro_torch.serve.speculative import default_draft_cfg, make_drafter
from repro_torch.serve.step import (pack_token_budget, page_bucket,
                                    prefill_bucket, scatter_prefill_pages)
from repro_torch.serve.tracing import (NULL_STEP, Tracer, chrome_trace,
                                       export_chrome_trace)


#: families whose decode cache can use the paged (block-table) layout —
#: the reference's ``PAGEABLE_ARCHS``
PAGEABLE_ARCHS = ("dense", "moe", "audio")


def _tree_bytes(tree) -> int:
    """Bytes of the tensors of a nested dict."""
    return sum(_tree_bytes(v) if isinstance(v, dict)
               else v.numel() * v.element_size() for v in tree.values())


@dataclass
class Request:
    """One request's lifecycle record; ``run()`` returns these.
    ``done=False`` marks a request cut by ``max_steps`` (partial or
    empty ``out``). A preempted request keeps its partial ``out`` while
    requeued and resumes by prefilling ``prompt + out``; one whose
    ``deadline`` passes while still QUEUED finishes ``done=False,
    expired=True``."""
    rid: int
    prompt: np.ndarray                 # (len,) int32
    max_new: int
    out: List[int] = field(default_factory=list)
    frames: Optional[np.ndarray] = None   # (enc_ctx, d_model), audio only
    images: Optional[np.ndarray] = None   # (n_img_tok, d_model), vlm only
    done: bool = False
    priority: int = 0                  # scheduler hint, ignored by FIFO
    deadline: Optional[float] = None   # absolute time.monotonic() bound
    expired: bool = False              # deadline passed while queued
    # host timestamp of the FIRST generated token
    first_tok_t: Optional[float] = field(default=None, repr=False)
    # (context length, prefix-cache salt) memoised by ServeEngine._salt
    salt_cache: Optional[tuple] = field(default=None, repr=False)


class ServeEngine:
    def __init__(self, cfg, params, *, slots: int = 4, max_len: int = 256,
                 eos_id: Optional[int] = None, temperature: float = 0.0,
                 seed: int = 0, paged: Optional[bool] = None,
                 page_size: int = 16, kv_pages: Optional[int] = None,
                 prefix_cache: bool = False, lazy: bool = False,
                 scheduler=None, mesh=None, strategy=None,
                 mixed: Optional[bool] = None,
                 chunk_tokens: int = 256, spec=None, tracer=None,
                 trace_level: int = 1, device=None):
        self.model = get_model(cfg)    # raises for the unported families
        # the reference's family and layout rules (engine.py:219-264)
        pageable = (cfg.arch_type in PAGEABLE_ARCHS
                    and cfg.sliding_window == 0)
        swa = " + SWA ring" if cfg.sliding_window else ""
        if (prefix_cache or lazy) and not pageable:
            raise ValueError(
                f"{cfg.name}: prefix_cache/lazy ride on the paged KV "
                f"pool, which needs a full-attention decoder "
                f"({'/'.join(PAGEABLE_ARCHS)}, no sliding window) — "
                f"unavailable for {cfg.arch_type}{swa}")
        if paged is None:
            paged = True if (prefix_cache or lazy) else pageable
        if paged and not pageable:
            raise ValueError(
                f"{cfg.name}: paged KV needs a full-attention decoder "
                f"({'/'.join(PAGEABLE_ARCHS)}, no sliding window); "
                f"{cfg.arch_type}{swa} keeps the dense layout "
                "(paged=False)")
        if (prefix_cache or lazy) and not paged:
            raise ValueError(
                f"{cfg.name}: prefix_cache/lazy ride on the paged pool; "
                "drop paged=False to use them")
        if mixed is None:
            mixed = bool(paged)
        if mixed and not paged:
            raise ValueError(
                f"{cfg.name}: the mixed token-slot step writes prefill "
                "chunks through the paged KV scatter; drop paged=False "
                "(or pass mixed=False) to serve this arch")
        if spec is not None:
            # the reference's checks (engine.py:299-316), same text
            if not mixed:
                raise ValueError(
                    f"{cfg.name}: speculative decode packs draft rows "
                    "into the mixed token-slot step; it needs the paged "
                    "layout with mixed=True (the default there)")
            if temperature > 0.0:
                raise ValueError(
                    "speculative decode is greedy-only (temperature "
                    f"0.0, got {temperature}): acceptance compares the "
                    "verifier's argmax tokens — stochastic speculative "
                    "sampling is a different acceptance rule")
            if chunk_tokens < max(slots, 1) * (spec.k + 1):
                raise ValueError(
                    f"chunk_tokens ({chunk_tokens}) must be >= slots * "
                    f"(spec.k + 1) = {slots * (spec.k + 1)}: every "
                    "slot's base decode row plus its k draft rows is "
                    "reserved in the budget before any prefill chunk")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if mixed and chunk_tokens < max(slots, 1):
            raise ValueError(
                f"chunk_tokens ({chunk_tokens}) must be >= slots "
                f"({slots}): every active slot's decode token is "
                "reserved in the budget before any prefill chunk")
        # -------- intra-operator (TP) sharding: the rank's view and shards
        self.mesh = mesh
        self.strategy = strategy
        self._rank = None
        if mesh is not None:
            self.strategy = strategy if strategy is not None \
                else Strategy(dtype=cfg.dtype)
            self._rank, params = self._shard(cfg, params, mesh,
                                             self.strategy)
        self.tp = self._rank.tp if self._rank is not None else 1
        self.cfg, self.params = cfg, params
        self.device = torch.device(device) if device is not None \
            else params["tok_embed" if "tok_embed" in params
                        else "embed"].device
        self.paged, self.mixed = bool(paged), bool(mixed)
        self.lazy, self.prefix_cache = bool(lazy), bool(prefix_cache)
        self.slots = slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.temperature = temperature
        self.page_size = page_size
        self.chunk_tokens = int(chunk_tokens)
        self.spec = spec
        if self.device.type == "cuda":
            self._check_kernel_limits()
        self._drafter = None if spec is None else make_drafter(
            spec, cfg, max_len=max_len, seed=seed, device=self.device)
        self.queue: Deque[Request] = deque()
        self.active: List[Optional[Request]] = [None] * slots
        self.finished: Dict[int, Request] = {}
        backend = "kernel" if self.device.type == "cuda" else "plain"
        # the reference's stats keys of the ported paths (prefill_traces
        # stays 0 on the mixed path: no separate prefill program); each
        # other key comes with the slice that ports its feature
        self.stats = {"decode_steps": 0, "decode_traces": 0,
                      "prefills": 0, "prefill_traces": 0,
                      "pages_in_use": 0, "peak_pages": 0,
                      "prefix_hit_blocks": 0, "prefix_miss_blocks": 0,
                      "prefix_tail_hits": 0, "prefix_evictions": 0,
                      "preemptions": 0, "cow_copies": 0,
                      "step_count": 0, "decode_tokens": 0,
                      "wall_time_s": 0.0, "tokens_per_s_ewma": 0.0,
                      # blocks registered from decode output
                      "prefix_decode_blocks": 0,
                      "prefill_chunk_tokens": 0, "expired": 0,
                      "decode_slot_steps": 0,
                      # distinct shapes the audio encoder's own program
                      # (the mixed step's admission) has run at
                      "encode_traces": 0,
                      # speculative decode: drafted tokens packed as
                      # verify rows, and how many the verifier accepted
                      # (bonus tokens are ordinary decode tokens); the
                      # accept rate is spec_accepted / spec_drafted, and
                      # (decode_tokens - prefills) / decode_slot_steps is
                      # 1.0 without speculation, in [1, k + 1] with it
                      "spec_drafted": 0, "spec_accepted": 0,
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
        self._prefix: Optional[PrefixCache] = None
        # mid-prefill slot table (mixed step): slot -> {ctx, n, cursor,
        # covered, dep, salt, seq}; always present so that _grow_and_cow
        # and _preempt can test membership on either path
        self._pf: Dict[int, dict] = {}
        self._admit_seq = 0
        # a set threading.Event makes a mixed step return before it
        # launches its program (the online driver's watchdog sets it)
        self.abort_event = None
        #: logits of the last device program run (mixed step: (T, 1, V);
        #: split path: a prefill's (1, 1, V) or a decode's (slots, 1, V))
        self.last_logits = None
        # distinct program shapes run: (T, bucket) of the mixed step;
        # padded prefill lengths and decode shapes of the split path
        self._shapes = set()
        self._prefill_lens = set()
        self._encode_shapes = set()
        # the pool and the enc-dec caches hold the rank's K/V heads (all
        # of them unsharded)
        self._cache_cfg = cfg if self._rank is None else \
            cfg.with_(num_kv_heads=self._rank.kv_heads)
        if self.paged:
            self._init_pool(kv_pages)
        elif self.model is transformer:
            # the slot table's dense rows (a ring of the window on
            # sliding-window configs) by the reference's cache_pspecs:
            # the rank's K/V heads, or, where Hkv does not divide tp, its
            # sequence slice of every row (tp.cache_rows)
            with tp.active(self._rank):
                self._cache = transformer.init_cache(
                    cfg, slots, max_len, device=self.device, cp=False)
        else:
            # the rank's H / tp heads of every state and conv tail, and the
            # hybrid's, the enc-dec family's and the VLM's dense rows (self
            # K/V and cross K/V each) by tp.cache_rows
            kw = {"cp": False} if cfg.arch_type == "vlm" else {}
            with tp.active(self._rank):
                self._cache = self.model.init_cache(cfg, slots, max_len,
                                                    device=self.device, **kw)
        self._cache["pos"] = torch.zeros((slots,), dtype=torch.int32,
                                         device=self.device)
        # bucketing: attention masks make right-padding exact for dense
        # decoders; MoE capacity routing and the SSM recurrence are
        # perturbed by pad tokens, so the MoE and SSM families and the
        # hybrid prefill at the exact length
        self._bucketed = cfg.arch_type == "dense"
        sl = self._cache.get("kv_slice")
        self._window = max_len if self.paged or "kv" not in self._cache \
            else sl.total if sl is not None \
            else self._cache["kv"]["k"].shape[2]

    @staticmethod
    def _shard(cfg, params, mesh, strategy):
        """The rank's view of ``mesh`` and its shards of ``params`` (full
        leaves are sliced; leaves already of the rank's block shape are
        kept), by the Megatron layout whatever the strategy's
        ``seq_parallel`` / ``fsdp`` (``core/strategy.py::serving``).
        The mesh's axes are some of ("pod", "data", "model"); another
        raises ``ValueError`` naming them."""
        axes = mesh_axes(mesh)
        if set(axes) - {"pod", "data", "model"}:
            raise ValueError(f"{cfg.name}: serving on a {axes} mesh: the "
                             "engine takes the axes 'pod', 'data' and "
                             "'model' only")
        rank = tp.Rank.of(mesh, cfg)
        return rank, tp.shard_params(params, full_shapes(cfg),
                                     serving(strategy), mesh, cfg)

    def _check_kernel_limits(self):
        """On a CUDA device, refuse at construction what a kernel of this
        engine's path cannot take (it would refuse at the first step,
        after ``submit`` took the request off the queue): paged attention
        on the paged layout, flash attention in every split-path prefill
        of a dense or MoE decoder (paged or not), of the hybrid or of the
        VLM and in every enc-dec admission on either path (the encoder),
        the fused MLP in every dense-decoder, hybrid and VLM program (an
        MoE layer and the enc-dec family's plain-GeLU MLP run none), the
        SSD scan in every SSM and hybrid prefill. Under a mesh the
        kernels see the rank's shapes: its query heads, the K/V heads they
        read, its d_ff / tp and its SSD heads H / tp."""
        cfg = self.cfg
        hq, hkv, d_ff = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff
        ssm_heads = cfg.ssm_heads
        r = getattr(self, "_rank", None)      # None: unsharded
        if r is not None:
            hq, d_ff = r.heads, d_ff // r.tp
            hkv = r.kv_heads if r.kv_read is None else 1
            ssm_heads //= r.tp
        checks = []
        if self.paged:
            checks.append(("the paged KV layout runs the paged-attention "
                           "kernel", "; pick a page_size or layout it takes "
                           "(paged=False)", paged_attention.kernel_limits(
                               cfg.dtype, self.page_size, hq, hkv,
                               cfg.head_dim)))
        if cfg.arch_type in ("ssm", "hybrid"):
            checks.append(("every prefill runs the SSD-scan kernel in each "
                           "Mamba layer", "", ssd_scan.kernel_limits(
                               cfg.dtype, ssm_heads, cfg.ssm_head_dim,
                               cfg.ssm_state, cfg.ssm_chunk)))
        if cfg.arch_type in ("dense", "moe", "hybrid", "vlm") \
                and not self.mixed:
            checks.append(("every split-path prefill runs the "
                           "flash-attention kernel", "",
                           flash_attention.kernel_limits(
                               cfg.dtype, hq, hkv, cfg.head_dim)))
        if cfg.arch_type == "audio":
            checks.append(("every admission's encoder (and each split-path "
                           "prefill's decoder) runs the flash-attention "
                           "kernel", "", flash_attention.kernel_limits(
                               cfg.dtype, hq, hkv, cfg.head_dim)))
        if cfg.arch_type in ("dense", "hybrid", "vlm") and not cfg.is_moe:
            checks.append(("every program runs the fused-MLP kernel", "",
                           fused_mlp.kernel_limits(cfg.dtype, cfg.d_model,
                                                   d_ff)))
        if self.spec is not None and self.spec.drafter == "model":
            dc = self.spec.draft_cfg or default_draft_cfg(cfg)
            checks.append((f"the draft model {dc.name}'s forward runs the "
                           "flash-attention kernel", "",
                           flash_attention.kernel_limits(
                               dc.dtype, dc.num_heads, dc.num_kv_heads,
                               dc.head_dim)))
            checks.append((f"the draft model {dc.name}'s forward runs the "
                           "fused-MLP kernel", "", fused_mlp.kernel_limits(
                               dc.dtype, dc.d_model, dc.d_ff)))
        for what, hint, why in checks:
            if why:
                raise ValueError(f"{cfg.name}: on {self.device} {what}, "
                                 f"which {why}{hint}")

    def _init_pool(self, kv_pages: Optional[int]):
        """The paged pool (page 0 is the null page: padding / inactive),
        the page allocator and the mid-prefill slot table."""
        pps = pages_for(self.max_len, self.page_size)  # blocks a slot
        self.kv_pages = kv_pages if kv_pages is not None \
            else self.slots * pps
        if self.kv_pages < 1:
            raise ValueError(f"kv_pages must be >= 1, got {self.kv_pages}")
        cfg = self.cfg
        self._cache = {"kv": kvcache.init_paged_kv(
            cfg.num_layers, self.kv_pages + 1, self.page_size,
            self._cache_cfg.num_kv_heads, cfg.head_dim,
            getattr(torch, cfg.dtype), self.device)}
        if cfg.arch_type == "audio":
            # the cross K/V stays a dense block a slot (fixed length), of
            # the rank's K/V heads
            self._cache["xkv"] = self.model.init_cache(
                self._cache_cfg, self.slots, 1, device=self.device)["xkv"]
        # the DEVICE page table is clipped to the power-of-two bucket of
        # the page high-water mark (_sync_ptab); the host mirror is full
        self._pps = pps
        self._gather = 1
        self._hw_blocks = 1
        self._ptab = np.zeros((self.slots, pps), np.int64)
        self._ptab_dirty = True
        self._alloc = PageAllocator(self.kv_pages, self.page_size,
                                    first_page=1)
        if self.prefix_cache:
            self._prefix = PrefixCache(self._alloc, self.page_size)
        self._sync_ptab()

    # ------------------------------------------------------------ memory
    def kv_bytes(self) -> int:
        """GLOBAL device bytes of the resident decode state, allocated up
        front: the KV pool or rows, the enc-dec cross K/V blocks, the
        VLM's self K/V rows (``kv_g``, ``kv_t``) and image K/V blocks
        (``xkv``), the SSM states and conv tails (cursors and the page
        table excluded). Under a mesh: the rank's bytes times tp where the
        K/V heads or the dense rows' sequence are sharded, the rank's where
        they are replicated; for the SSM family and the hybrid the bytes
        of the unsharded cache (each rank's conv tails hold all of B and
        C)."""
        r = self._rank
        if r is not None and self.cfg.arch_type in ("ssm", "hybrid"):
            with tp.active(None):
                full = self.model.init_cache(self.cfg, self.slots,
                                             self.max_len, device="meta")
            return _tree_bytes({k: v for k, v in full.items()
                                if k != "pos"})
        split = r is not None and (r.kv_sharded or any(
            isinstance(v, tp.SeqSlice) for v in self._cache.values()))
        return self.per_device_kv_bytes() * (r.tp if split else 1)

    def per_device_kv_bytes(self) -> int:
        """Resident decode-state bytes on this rank's device: 1/tp of
        :meth:`kv_bytes` where the K/V heads divide the model axis or the
        dense rows are the rank's sequence slice; equal to it
        unsharded."""
        return _tree_bytes({k: v for k, v in self._cache.items()
                            if k not in ("pos", "ptab")
                            and not isinstance(v, tp.SeqSlice)})

    # -------------------------------------------------------- the program
    def _mixed_fn(self, tokens, pos, slot, active, wnull):
        """ONE device program for a mixed token-slot batch of T =
        ``chunk_tokens`` rows: decode tokens, prefill-chunk tokens and
        pads, each with its context position, page-table row, sample
        flag, and null-page write redirect (padding rows). Returns the
        sampled token per row (0 where not active). An enc-dec row reads
        its slot's cross K/V (``"xslot"``: gathered a layer at a time)."""
        ptab_rows = self._cache["ptab"][slot]          # (T, bucket)
        view = {"kv": self._cache["kv"], "ptab": ptab_rows,
                "wtab": torch.where(wnull[:, None],
                                    torch.zeros_like(ptab_rows), ptab_rows)}
        if "xkv" in self._cache:
            view["xkv"], view["xslot"] = self._cache["xkv"], slot
        with tp.active(self._rank):
            logits, _ = self.model.decode_step(self.params, view, tokens,
                                               pos, self.cfg)
            tok = self._sample(logits[:, -1])
        self.last_logits = logits
        return torch.where(active, tok, torch.zeros_like(tok))

    def _encode_fn(self, frames, slot: int):
        """Audio admission under the mixed step: run the encoder (its own
        program) on ``frames`` (1, enc_ctx, d) and park each decoder
        layer's cross K/V in slot ``slot``'s block.
        ``stats["encode_traces"]`` counts the distinct frame shapes run —
        one a config, as the reference's one trace."""
        self._encode_shapes.add(tuple(frames.shape))
        self.stats["encode_traces"] = len(self._encode_shapes)
        xkv = self._cache["xkv"]
        with tp.active(self._rank):
            enc_out = self.model.encode(self.params, frames, self.cfg)
            for i, lp in enumerate(transformer.unstack(
                    self.params["dec_layers"], self.cfg.num_layers)):
                for key, new in self.model.cross_kv(lp, enc_out,
                                                    self.cfg).items():
                    xkv[key][i, slot] = new[0]

    def _decode_fn(self, tokens, pos, active):
        """Split path: ONE batched decode advancing every slot (the cache
        in place; on the paged layout through the page table), on-device
        sampling and active-slot masking. Returns the sampled token per
        slot (0 where not active)."""
        self._shapes.add((tuple(tokens.shape),
                          self._gather if self.paged else 0))
        self.stats["decode_traces"] = len(self._shapes)
        with tp.active(self._rank):
            logits, self._cache = self.model.decode_step(
                self.params, self._cache, tokens, pos, self.cfg)
            tok = self._sample(logits[:, -1])
        self.last_logits = logits
        tok = torch.where(active, tok, torch.zeros_like(tok))
        self._cache["pos"] = torch.where(active, pos + 1, pos)
        return tok

    def _prefill_fn(self, tokens, slot: int, last_pos: int, pages=None,
                    extra=None):
        """Split path: prefill one (bucket-padded) prompt (1, blen), sample
        its first token at ``last_pos`` and store the fresh per-request
        cache: the dense layout's row ``slot`` of every leaf (K/V, the
        enc-dec cross K/V, and the SSM states and conv tails of the SSM
        family and the hybrid), written in place by the prefill itself;
        on the paged layout a scratch cache of whole pages, scattered
        through ``pages`` (and its cross K/V copied into the slot's
        block). ``extra`` holds the request's modality tensor beside the
        tokens: an enc-dec request's ``frames`` (1, enc_ctx, d), a VLM
        request's ``image_embeds`` (1, N, d). Only a bucketed (dense)
        prefill gathers its logits at ``last_pos``; the others run at the
        exact length. ``pos[slot] = last_pos + 1``. Returns the token (a
        0-d tensor)."""
        blen = tokens.shape[1]
        self._prefill_lens.add(blen)
        self.stats["prefill_traces"] = len(self._prefill_lens)
        batch = {"tokens": tokens, **(extra or {})}
        kw = {"last_pos": last_pos} if self._bucketed else {}
        with tp.active(self._rank):
            logits = self._prefill_run(batch, slot, pages, kw)
            tok = self._sample(logits[0, -1])
        self.last_logits = logits
        self._cache["pos"][slot] = last_pos + 1
        return tok

    def _prefill_run(self, batch, slot: int, pages, kw):
        """:meth:`_prefill_fn`'s program: the prefill and its cache
        writes. Returns the logits."""
        if self.paged:
            clen = pages_for(batch["tokens"].shape[1],
                             self.page_size) * self.page_size
            with tp.active(None):      # the pool's heads, whole rows
                c1 = self.model.init_cache(self._cache_cfg, 1, clen,
                                           device=self.device)
            logits, c1 = self.model.prefill(self.params, batch, self.cfg,
                                            c1, **kw)
            scatter_prefill_pages(self._cache["kv"], c1["kv"], pages,
                                  self.page_size)
            for key, leaf in self._cache.get("xkv", {}).items():
                leaf[:, slot] = c1["xkv"][key][:, 0]
        else:
            row = {key: {k: leaf[:, slot:slot + 1] for k, leaf in sub.items()}
                   for key, sub in self._cache.items()
                   if isinstance(sub, dict)}
            row.update({k: v for k, v in self._cache.items()
                        if isinstance(v, tp.SeqSlice)})
            logits, _ = self.model.prefill(self.params, batch, self.cfg,
                                           row, **kw)
        return logits

    def _sample(self, logits):
        """Sample a token a row of ``logits`` (the last position's); under
        a mesh every rank takes rank 0's tokens."""
        tok = sample_tokens(logits, generator=self._gen,
                            temperature=self.temperature)
        return tp.broadcast_from_root(tok, "tokens")

    # ------------------------------------------------ agreement of ranks
    def _now(self) -> float:
        """The clock every deadline decision reads: ``time.monotonic()``,
        rank 0's under a mesh."""
        now = time.monotonic()
        if self._rank is None:
            return now
        t = torch.tensor([now], dtype=torch.float64, device=self.device)
        with tp.active(self._rank):
            return float(tp.broadcast_from_root(t, "clock").item())

    def _same_step(self, *arrays):
        """Under a mesh: raise unless every rank packed the same host
        arrays for the program about to run (one all-reduce of a
        checksum)."""
        if self._rank is None:
            return
        crc = 0
        for a in arrays:
            crc = zlib.crc32(np.ascontiguousarray(a).tobytes(), crc)
        with tp.active(self._rank):
            same = tp.same_on_all(crc, "step_check", self.device)
        if not same:
            raise RuntimeError(
                f"tensor-parallel rank {self._rank.rank} of {self.tp}: the "
                f"ranks packed different programs at step "
                f"{self.stats['step_count']} (their host engines diverged)")

    # --------------------------------------------------------- scheduling
    def submit(self, rid: int, prompt: np.ndarray, max_new: int, *,
               frames: Optional[np.ndarray] = None,
               images: Optional[np.ndarray] = None, priority: int = 0,
               deadline_s: Optional[float] = None):
        """Queue a request. Rejects what the engine can NEVER hold —
        prompts at/over ``max_len``, and on the pool requests whose
        minimum admission reservation (lazy: the prompt plus its first
        decode write) or worst-case context exceeds the whole pool —
        instead of deadlocking the scheduler's head. ``deadline_s`` (> 0)
        is an SLO: the shipped policies admit the nearest deadline first
        and give it the mixed step's prefill budget first, and a request
        still QUEUED past it finishes ``done=False, expired=True``.
        An enc-dec (audio) request must carry ``frames``, its
        ``(encoder_ctx, d_model)`` frame embeddings (the stubbed audio
        frontend's output), and a VLM request ``images``, its
        ``(num_image_tokens, d_model)`` patch embeddings (the stubbed
        vision frontend's output), each stored as float32; either on
        another family is refused, as in the reference.
        Returns the LIVE Request record (``out`` grows as it decodes)."""
        prompt, frames, images, worst = self.check_request(
            rid, prompt, max_new, frames=frames, images=images,
            deadline_s=deadline_s)
        if self.paged:
            # pre-book the worst case in the bounded-gather high-water mark
            # at submit, so lazy growth never re-buckets mid-decode
            self._hw_blocks = max(self._hw_blocks, worst)
        deadline = None
        if deadline_s is not None:
            deadline = self._now() + float(deadline_s)
        req = Request(rid, prompt, int(max_new), frames=frames,
                      images=images, priority=int(priority),
                      deadline=deadline)
        self.queue.append(req)
        explain = getattr(self._sched, "explain", None)
        self.tracer.req_event(
            rid, "submitted", prompt_tokens=int(prompt.size),
            max_new=int(max_new), queue_depth=len(self.queue),
            **(explain(req) if explain is not None else {}))
        return req

    def check_request(self, rid: int, prompt, max_new: int, *,
                      frames=None, images=None, deadline_s=None):
        """``submit``'s checks, changing nothing: raises ``ValueError`` for
        a request this engine could never serve. Returns (prompt as int32,
        frames and images as float32 or None, the worst-case pages of its
        context on the pool)."""
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
        worst = 0
        if self.paged:
            cap = min(prompt.size + max_new - 1, self.max_len)
            worst = pages_for(cap, self.page_size)
            if self.lazy:
                need = pages_for(min(prompt.size + 1, cap), self.page_size)
                if need > self.kv_pages:
                    raise ValueError(
                        f"request {rid}: minimum admission reservation is "
                        f"{need} KV pages ({self.page_size} tokens each) "
                        f"but the pool holds {self.kv_pages} — it could "
                        f"never be placed; raise kv_pages or shorten the "
                        f"prompt")
            if worst > self.kv_pages:
                raise ValueError(
                    f"request {rid}: worst-case context needs {worst} KV "
                    f"pages ({self.page_size} tokens each) but the pool "
                    f"holds {self.kv_pages}; raise kv_pages or lower "
                    f"prompt+max_new")
        if self.cfg.arch_type == "audio":
            if frames is None:
                raise ValueError(
                    f"request {rid}: {self.cfg.name} is an enc-dec arch; "
                    "submit(..., frames=(encoder_ctx, d_model)) frame "
                    "embeddings (the stubbed audio frontend's output)")
            frames = np.asarray(frames, np.float32)
            want = (self.cfg.encoder_ctx, self.cfg.d_model)
            if frames.shape != want:
                raise ValueError(
                    f"request {rid}: frames shape {frames.shape} != {want}")
        elif frames is not None:
            raise ValueError(
                f"request {rid}: frames are only meaningful for audio "
                f"archs, not {self.cfg.arch_type}")
        if self.cfg.arch_type == "vlm":
            if images is None:
                raise ValueError(
                    f"request {rid}: {self.cfg.name} is a VLM arch; "
                    "submit(..., images=(num_image_tokens, d_model)) "
                    "patch embeddings (the stubbed vision frontend's "
                    "output)")
            images = np.asarray(images, np.float32)
            want = (self.cfg.num_image_tokens, self.cfg.d_model)
            if images.shape != want:
                raise ValueError(
                    f"request {rid}: images shape {images.shape} != {want}")
        elif images is not None:
            raise ValueError(
                f"request {rid}: images are only meaningful for vlm "
                f"archs, not {self.cfg.arch_type}")
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(
                f"request {rid}: deadline_s must be > 0, got {deadline_s}")
        return prompt, frames, images, worst

    def _expire_queued(self, now: float):
        """Finish every QUEUED request whose deadline has passed with
        ``done=False, expired=True`` (a preempted one keeps its partial
        output). Active slots never expire."""
        if not any(r.deadline is not None for r in self.queue):
            return
        kept: Deque[Request] = deque()
        for req in self.queue:
            if req.deadline is not None and now > req.deadline:
                req.expired = True
                self.finished[req.rid] = req
                self.stats["expired"] += 1
                self.tracer.finish_request(req.rid, "expired",
                                           tokens=len(req.out))
            else:
                kept.append(req)
        self.queue = kept

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
        if self._prefix is not None:
            self.stats["prefix_hit_blocks"] = self._prefix.hit_blocks
            self.stats["prefix_miss_blocks"] = self._prefix.miss_blocks
            self.stats["prefix_tail_hits"] = self._prefix.tail_hits

    def _salt(self, req: Request, ctx: np.ndarray):
        """Prefix-cache namespace. Causal KV of a dense decoder depends on
        the prefix alone, so every block is portable: None. MoE capacity
        routing depends on the whole sequence, so an MoE block keys on
        ``("moe-ctx", sha1(ctx))``: only identical contexts share. An
        enc-dec decoder's KV also depends on the encoder output, so its
        blocks key on ``("frames", sha1(frames))``: the same prompt prefix
        under the same audio shares. Memoised on the request: frames never
        change, and ``ctx`` (prompt + emitted) is determined by its length
        over a request's lifetime."""
        if self.cfg.arch_type == "moe":
            if req.salt_cache is None or req.salt_cache[0] != len(ctx):
                req.salt_cache = (len(ctx), ("moe-ctx", hashlib.sha1(
                    np.ascontiguousarray(ctx).tobytes()).hexdigest()))
            return req.salt_cache[1]
        if req.frames is not None:
            if req.salt_cache is None:
                req.salt_cache = (0, ("frames", hashlib.sha1(
                    np.ascontiguousarray(req.frames).tobytes()).hexdigest()))
            return req.salt_cache[1]
        return None

    def _reserve_tokens(self, req: Request, n: int) -> int:
        """Tokens slot admission reserves for a context of ``n``: lazy,
        the context plus its first decode write, clamped to the request's
        remaining worst case (a request finishing on its prefill token
        writes no decode token); else the worst case."""
        worst = min(n + req.max_new - len(req.out) - 1, self.max_len)
        return min(n + 1, worst) if self.lazy else worst

    def _alloc_evicting(self, s: int, reserve: int, shared: List[int]):
        """``allocator.alloc`` that evicts cold prefix blocks first when
        that can cover the shortfall (else the request waits for
        retirements, and flushed blocks would buy nothing)."""
        got = self._alloc.alloc(s, reserve, shared=shared)
        if got is None and self._prefix is not None:
            need = (pages_for(reserve, self.page_size) - len(shared)
                    - self._alloc.free_pages)
            keep = frozenset(shared)
            if 0 < need <= self._prefix.evictable_pages(keep=keep):
                while need > 0 and self._prefix.evict_one(keep=keep):
                    self.stats["prefix_evictions"] += 1
                    need -= 1
                got = self._alloc.alloc(s, reserve, shared=shared)
        return got

    def _place(self, s: int, req: Request, ctx: np.ndarray):
        """Split path: reserve slot ``s``'s pages — prefix match, adopt
        the shared pages, draw fresh ones (evicting cold prefix blocks
        when short) and register the context's full blocks. Returns
        (block-ordered pages, shared head count) or (None, 0) on
        backpressure."""
        n = len(ctx)
        reserve = self._reserve_tokens(req, n)
        shared: List[int] = []
        salt = tail_page = None
        if self._prefix is not None:
            salt = self._salt(req, ctx)
            # a partial-tail hit costs a copy-on-write at the first decode
            # write, which only lazy mode's reclaim ladder can pay for
            full_pages, tail_page, _ = self._prefix.match(
                ctx, salt=salt, want_tail=self.lazy)
            shared = list(full_pages)
            if tail_page is not None:
                shared.append(tail_page)
        got = self._alloc_evicting(s, reserve, shared)
        if got is None:
            return None, 0
        if self._prefix is not None:
            # count reuse on successful adoption only (a backpressured
            # head-of-line request re-matches every step)
            full = len(shared) - (1 if tail_page is not None else 0)
            self._prefix.hit_blocks += full
            self._prefix.miss_blocks += n // self.page_size - full
            if tail_page is not None:
                self._prefix.tail_hits += 1
            self._prefix.insert(ctx, got, salt=salt)
        self._note_pool()
        return got, len(shared)

    def _place_mixed(self, s: int, req: Request, ctx: np.ndarray):
        """Mixed path: as :meth:`_place`, but the prefill runs later,
        chunk by chunk, so nothing is registered here (the step registers
        blocks as the cursor passes them) and the match may also adopt
        pages of a slot still MID-PREFILL over the same context. Returns
        ``(pages, covered, dep)``: ``covered`` context tokens whose KV
        this slot must not rewrite, ``dep`` ``(donor slot, tokens)`` while
        a donor still has to write some of them; ``(None, 0, None)`` on
        backpressure."""
        n = len(ctx)
        reserve = self._reserve_tokens(req, n)
        ps = self.page_size
        shared: List[int] = []
        covered, dep, tail_page = 0, None, None
        if self._prefix is not None:
            salt = self._salt(req, ctx)
            full_pages, tail_page, _ = self._prefix.match(
                ctx, salt=salt, want_tail=self.lazy)
            shared = list(full_pages)
            covered = len(full_pages) * ps
            if tail_page is not None:
                # a matched tail covers the whole remaining context; CoW
                # copies it before the first decode write
                shared.append(tail_page)
                covered = n
            elif covered < n:
                # an in-flight donor over the same context extends the
                # coverage past the tree
                for d, st in self._pf.items():
                    if st["salt"] != salt:
                        continue
                    dctx = st["ctx"]
                    lim = min(n, len(dctx)) // ps * ps
                    m = covered
                    while m + ps <= lim and np.array_equal(
                            ctx[m:m + ps], dctx[m:m + ps]):
                        m += ps
                    if m > covered:
                        shared.extend(
                            self._alloc.pages_of(d)[covered // ps:m // ps])
                        dep = (d, m)
                        covered = m
                        break
        got = self._alloc_evicting(s, reserve, shared)
        if got is None:
            return None, 0, None
        if self._prefix is not None:
            # every covered block, tree hit or in-flight adoption, is
            # prefill work this request skips
            full = covered // ps if tail_page is None else len(full_pages)
            self._prefix.hit_blocks += full
            self._prefix.miss_blocks += n // ps - full
            if tail_page is not None:
                self._prefix.tail_hits += 1
        self._note_pool()
        return got, covered, dep

    @staticmethod
    def _context(req: Request) -> np.ndarray:
        """What admission prefills: the prompt, plus the tokens already
        emitted when a preempted request resumes."""
        return req.prompt if not req.out else np.concatenate(
            [req.prompt, np.asarray(req.out, np.int32)])

    def _admit_mixed(self):
        """Place pages and ENQUEUE the prefill work (no device call: the
        step drains it chunk by chunk). The slot is active at once; its
        first token is sampled on the chunk holding the last context
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
            ctx = self._context(req)
            n = len(ctx)
            got, covered, dep = self._place_mixed(s, req, ctx)
            if got is None:
                return
            self._ptab[s] = 0
            self._ptab[s, :len(got)] = got
            self._ptab_dirty = True
            del self.queue[qi]
            if req.frames is not None:
                self._encode_fn(torch.from_numpy(req.frames[None]).to(
                    self.device), s)
            self.active[s] = req
            self._pos[s] = 0
            self._last[s] = 0
            self.tracer.req_event(req.rid, "admitted", slot=s,
                                  ctx_tokens=n, covered=int(covered),
                                  resumed=bool(req.out))
            # cursor = next context position to compute; covered KV is
            # skipped but for the last context token, which runs for its
            # first-token logits (its write goes to the null page)
            self._pf[s] = {"ctx": ctx, "n": n,
                           "cursor": int(min(covered, n - 1)),
                           "covered": int(covered), "dep": dep,
                           "salt": (self._salt(req, ctx)
                                    if self._prefix is not None else None),
                           "seq": self._admit_seq}
            self._admit_seq += 1

    def _admit(self):
        """Split path: admit into free slots, each with a synchronous
        prefill (its own device program); on the paged layout the slot's
        worst-case pages are placed first, and when the scheduler's pick
        cannot be placed, nothing is (head-of-line). A request complete on
        its prefill token (max_new, EOS, capacity) never occupies the
        slot. A prompt the chunked SSD cannot take raises here, after it
        left the queue, as the reference's assert does."""
        while True:
            qi = self._sched.next_index(self.queue)
            if qi is None:
                return
            s = self._free_slot()
            if s is None:
                return
            req = self.queue[qi]
            ctx = self._context(req)
            n = len(ctx)
            blen = prefill_bucket(n, cap=self._window) if self._bucketed \
                else n
            pages = None
            if self.paged:
                got, n_shared = self._place(s, req, ctx)
                if got is None:
                    return
                self._ptab[s] = 0
                self._ptab[s, :len(got)] = got
                self._ptab_dirty = True
                page_vec = np.zeros(pages_for(blen, self.page_size),
                                    np.int64)
                m = min(len(page_vec), len(got))
                page_vec[:m] = got[:m]
                # shared head pages already hold this prefix's KV, and
                # other slots read them: their blocks go to the null page
                page_vec[:min(n_shared, len(page_vec))] = 0
                pages = torch.from_numpy(page_vec).to(self.device)
            del self.queue[qi]
            self.tracer.req_event(req.rid, "admitted", slot=s,
                                  ctx_tokens=n, resumed=bool(req.out))
            if self.paged:
                self._sync_ptab()
            padded = np.zeros((1, blen), np.int32)
            padded[0, :n] = ctx
            self._same_step(padded, np.array([s, n], np.int64),
                            page_vec if self.paged else np.zeros(0))
            tokens = torch.from_numpy(padded).to(self.device)
            extra = {key: torch.from_numpy(arr[None]).to(self.device)
                     for key, arr in (("frames", req.frames),
                                      ("image_embeds", req.images))
                     if arr is not None}
            tok = int(self._prefill_fn(tokens, s, n - 1, pages, extra))
            self.stats["prefills"] += 1
            self.stats["decode_tokens"] += 1
            req.out.append(tok)
            self.tracer.req_tokens(req.rid, 1)
            if req.first_tok_t is None:
                req.first_tok_t = time.monotonic()
                self.tracer.req_event(req.rid, "first_token",
                                      prefill_tokens=n)
            self._pos[s] = n
            self._last[s] = tok
            hit_eos = self.eos_id is not None and tok == self.eos_id
            if len(req.out) >= req.max_new or hit_eos or n >= self.max_len:
                req.done = True
                self.finished[req.rid] = req
                self.tracer.finish_request(req.rid, "completed",
                                           tokens=len(req.out))
                if self.paged:
                    self._release_pages(s)
            else:
                self.active[s] = req

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
        if self.paged:
            self._release_pages(s)

    # -------------------------------------------- lazy growth + CoW + preempt
    def _preempt(self, s: int):
        """Evict slot ``s``: release its pages (prefix pages only drop a
        reference and usually stay cached) and requeue the request,
        partial output intact, for re-prefill. A MID-PREFILL victim
        cascades to every slot that adopted its pages beyond what its
        cursor wrote: that KV will never exist, so those re-prefill
        too."""
        req = self.active[s]
        st = self._pf.pop(s, None)
        self.active[s] = None
        if self.paged:
            self._release_pages(s)
        self._sched.requeue(self.queue, req)
        self.stats["preemptions"] += 1
        self.tracer.req_preempted(req.rid, slot=s, tokens=len(req.out),
                                  mid_prefill=st is not None)
        if st is not None:
            for d, dst in list(self._pf.items()):
                if dst["dep"] is not None and dst["dep"][0] == s \
                        and st["cursor"] < dst["dep"][1]:
                    self._preempt(d)

    def preempt(self, s: int):
        """Cancel slot ``s`` and requeue its request (any layout): the
        online driver's recovery path. The request keeps its partial
        output and resumes by re-prefill; greedy streams do not change."""
        if not 0 <= s < self.slots or self.active[s] is None:
            raise ValueError(f"slot {s} holds no active request")
        self._preempt(s)

    def _reclaim_one(self, needy: int) -> bool:
        """Free pool capacity for slot ``needy``: evict one cold prefix
        block if there is one, else preempt the scheduler's victim.
        False when ``needy`` itself was preempted or nothing is left to
        reclaim (the caller skips the slot this step)."""
        if self._prefix is not None and self._prefix.evict_one():
            self.stats["prefix_evictions"] += 1
            return True
        victims = [(t, len(self.active[t].out), self.active[t].priority)
                   for t in range(self.slots) if self.active[t] is not None]
        if not victims:
            return False
        v = self._sched.pick_victim(victims)
        self._preempt(v)
        return v != needy

    def _extend_reclaiming(self, s: int, n_tokens: int):
        """``allocator.extend`` with the reclaim ladder: the fresh pages,
        or None when slot ``s`` was preempted to satisfy itself."""
        while True:
            fresh = self._alloc.extend(s, n_tokens)
            if fresh is not None:
                self._note_pool()
                return fresh
            if not self._reclaim_one(s):
                return None

    def _cow_reclaiming(self, s: int, blk: int) -> bool:
        """Copy-on-write slot ``s``'s page at ``blk`` (allocator swap, then
        the device copy of every layer's K and V), reclaiming when no
        page is free. False when slot ``s`` was preempted instead."""
        while True:
            old = self._alloc.pages_of(s)[blk]
            new = self._alloc.cow(s, blk)
            if new is not None:
                if new != old:
                    kvcache.copy_page(self._cache["kv"], old, new)
                    self._ptab[s, blk] = new
                    self._ptab_dirty = True
                    self.stats["cow_copies"] += 1
                    self._note_pool()
                return True
            if not self._reclaim_one(s):
                return False

    def _grow_and_cow(self):
        """Before the decode rows write at each slot's cursor: grow lazy
        reservations across page boundaries and copy-on-write a write
        target that is still shared. Either may preempt slots (the needy
        one included) when the pool runs dry."""
        ps = self.page_size
        for s in range(self.slots):
            # mid-prefill slots write no decode row this step, and their
            # shared head blocks must not be copied
            if self.active[s] is None or s in self._pf:
                continue
            pos = int(self._pos[s])
            if self.lazy and \
                    pages_for(pos + 1, ps) > len(self._alloc.pages_of(s)):
                fresh = self._extend_reclaiming(s, pos + 1)
                if fresh is None:
                    continue                  # s was preempted
                w = len(self._alloc.pages_of(s))
                self._ptab[s, w - len(fresh):w] = fresh
                self._ptab_dirty = True
            own = self._alloc.pages_of(s)
            blk = pos // ps
            if blk < len(own) and self._alloc.refcount(own[blk]) > 1:
                self._cow_reclaiming(s, blk)

    def _register_decode_block(self, s: int, req: Request):
        """Slot ``s``'s cursor just crossed a page boundary: register the
        context's full blocks, so a repeat continuation (or this request's
        own re-prefill after a preemption) adopts them. KV exists for
        ``prompt + out[:-1]`` (the newest token is the next step's
        input)."""
        ctx = np.concatenate([req.prompt, np.asarray(req.out[:-1],
                                                     np.int32)])
        self.stats["prefix_decode_blocks"] += self._prefix.insert(
            ctx, self._alloc.pages_of(s), salt=self._salt(req, ctx))

    # ------------------------------------------------ speculative decode
    def _propose_drafts(self, decode_slots):
        """Ask the drafter for up to ``spec.k`` continuation tokens per
        decoding slot and reserve the pages their KV writes need (the
        reference's ``_propose_drafts``).

        ``k_s`` is clamped so every drafted position stays inside the
        request's remaining budget (``max_new``) and the context cap, so
        inside the worst case ``submit`` pre-booked in ``_hw_blocks``:
        drafting never re-buckets the page table (the program set stays
        one per (``chunk_tokens``, page bucket), speculation on or off).
        Under lazy growth the reservation is extended to cover the draft
        writes with a PLAIN extend — a guess never evicts prefix blocks
        or preempts a neighbour, so a dry pool truncates the draft (the
        rejection path returns the pages via ``PageAllocator.rollback``).
        Eager reservations already hold the worst case."""
        drafts = {}
        for s in decode_slots:
            req = self.active[s]
            P = int(self._pos[s])
            k_s = min(self.spec.k, req.max_new - len(req.out) - 1,
                      self.max_len - 1 - P)
            if k_s < 1:
                continue
            ctx = np.concatenate(
                [req.prompt, np.asarray(req.out, np.int64)])
            d = np.asarray(self._drafter.propose(ctx, k_s),
                           np.int64).reshape(-1)[:k_s]
            if len(d) and self.lazy:
                if self._alloc.extend(s, P + 1 + len(d)) is None:
                    # pool dry: keep only the drafts whose writes fit
                    # the pages already held (possibly none)
                    room = (len(self._alloc.pages_of(s)) * self.page_size
                            - P - 1)
                    d = d[:max(room, 0)]
                    if len(d):
                        self._alloc.extend(s, P + 1 + len(d))
                if len(d):
                    own = self._alloc.pages_of(s)
                    self._ptab[s, :len(own)] = own
                    self._ptab_dirty = True
                    self._note_pool()
            if len(d):
                drafts[s] = d
        return drafts

    def release_prefix_cache(self) -> int:
        """Flush every prefix block no live request still shares, freeing
        their pages. Returns the number of blocks evicted."""
        if self._prefix is None:
            return 0
        n = self._prefix.flush()
        self.stats["prefix_evictions"] += n
        self._note_pool()
        return n

    # -------------------------------------------------------------- serve
    def step(self) -> int:
        """Advance the engine by one step: the mixed token-slot step on
        the paged layout (:meth:`_step_mixed`), else the split path's
        admission with synchronous prefills and one batched decode
        (:meth:`_step_split`). Returns the tokens produced."""
        if self.mixed:
            return self._step_mixed()
        return self._step_split()

    def _step_split(self) -> int:
        """Split path (the reference's legacy branch of ``step``): admit
        with a synchronous prefill each, then ONE batched decode over the
        whole slot table when any slot is active."""
        t0 = time.perf_counter()
        before = self.stats["decode_tokens"]
        tr = self.tracer.begin_step(self.stats["step_count"])
        self._expire_queued(self._now())
        tr.lap("bookkeeping")
        self._admit()
        tr.lap("admit")
        if self.paged and (self.lazy or self._prefix is not None):
            self._grow_and_cow()
            tr.lap("bookkeeping")
        mask = np.array([r is not None for r in self.active])
        if mask.any():
            if self.paged:
                self._sync_ptab()
            tr.lap("pack")
            meta = np.stack([self._last, self._pos, mask]).astype(np.int32)
            self._same_step(meta, self._ptab[:, :self._gather]
                            if self.paged else np.zeros(0))
            dev = torch.from_numpy(meta).to(self.device)
            tok = self._decode_fn(dev[0][:, None], dev[1], dev[2].bool())
            tr.lap("dispatch")
            self.stats["decode_steps"] += 1
            self.stats["decode_slot_steps"] += int(mask.sum())
            toks = tok.cpu().numpy()
            tr.lap("sync")
            for s in range(self.slots):
                req = self.active[s]
                if req is None:
                    continue
                t = int(toks[s])
                req.out.append(t)
                self._pos[s] += 1
                self._last[s] = t
                self.stats["decode_tokens"] += 1
                tr.note_decode(s, req.rid, 1)
                self.tracer.req_tokens(req.rid, 1)
                self.tracer.req_detail(req.rid, "decode", slot=s,
                                       pos=int(self._pos[s]))
                if self._prefix is not None and \
                        self._pos[s] % self.page_size == 0:
                    self._register_decode_block(s, req)
                hit_eos = self.eos_id is not None and t == self.eos_id
                if len(req.out) >= req.max_new or hit_eos or \
                        self._pos[s] >= self.max_len:
                    self._retire(s)
        return self._finish_step(t0, before, tr)

    def _step_mixed(self) -> int:
        """One MIXED token-slot step: return at once while ``abort_event``
        is set; expire overdue queued requests, admit into free slots
        (pages only), grow and copy-on-write, then fill the
        ``chunk_tokens`` budget with every decoding slot's next token
        FIRST and prefill chunks after (the scheduler's ``prefill_key``
        order, then admission order), and run the whole batch as ONE
        device program. Admission runs again at the END so a request
        finishing on its prefill token frees its slot for the same-step
        queue. Returns the tokens produced."""
        t0 = time.perf_counter()
        before = self.stats["decode_tokens"]
        tr = self.tracer.begin_step(self.stats["step_count"])
        abort = self.abort_event
        if abort is not None and abort.is_set():
            # a cancellation point at the chunk boundary: no program runs
            return self._finish_step(t0, before, tr)
        self._expire_queued(self._now())
        self._admit_mixed()
        if self.lazy or self._prefix is not None:
            self._grow_and_cow()
        tr.lap("bookkeeping")
        # a dependency is met once the donor left the prefill table (it
        # finished; a donor preempted earlier already cascaded) or its
        # cursor passed the needed point
        for st in self._pf.values():
            if st["dep"] is not None:
                d, needed = st["dep"]
                dst = self._pf.get(d)
                if dst is None or dst["cursor"] >= needed:
                    st["dep"] = None
        decode_slots = [s for s in range(self.slots)
                        if self.active[s] is not None and s not in self._pf]
        drafts = self._propose_drafts(decode_slots) \
            if self._drafter is not None else {}
        tr.lap("draft")
        pkey = getattr(self._sched, "prefill_key", None)
        items = sorted(
            self._pf.items(),
            key=lambda kv: ((pkey(self.active[kv[0]])
                             if pkey is not None else ()), kv[1]["seq"]))
        allot = pack_token_budget(
            self.chunk_tokens,
            [1 + len(drafts.get(s, ())) for s in decode_slots],
            [{"slot": s, "cursor": st["cursor"], "n": st["n"],
              "dep": st["dep"]} for s, st in items])
        if not decode_slots and not allot:
            self._admit_mixed()
            return self._finish_step(t0, before, tr)
        T = self.chunk_tokens
        # rows: tokens, pos, slot, active, wnull — one host array, one copy
        meta = np.zeros((5, T), np.int32)
        meta[4] = 1                       # pads write to the null page
        r = 0
        base_row: Dict[int, int] = {}
        for s in decode_slots:
            meta[:, r] = (self._last[s], self._pos[s], s, 1, 0)
            base_row[s] = r
            r += 1
            # draft rows: same slot, consecutive positions. Draft row i
            # carries d[i] at position P+1+i; its logits are the
            # verifier's token for P+2+i, valid exactly when d[0..i] all
            # matched. decode_step scatters every row's K/V before any
            # row attends, and a row at p attends to kv_len p + 1, so the
            # base row never sees draft KV and draft row i sees the base
            # write and drafts 0..i-1.
            d = drafts.get(s, ())
            if len(d):
                n = len(d)
                meta[0, r:r + n] = d
                meta[1, r:r + n] = self._pos[s] + 1 + np.arange(n)
                meta[2, r:r + n] = s
                meta[3, r:r + n] = 1
                meta[4, r:r + n] = 0
                r += n
        emit_row: Dict[int, int] = {}
        for s, start, count in allot:
            st = self._pf[s]
            ctx, last = st["ctx"], st["n"] - 1
            span = np.arange(start, start + count)
            meta[0, r:r + count] = ctx[start:start + count]
            meta[1, r:r + count] = span
            meta[2, r:r + count] = s
            # covered positions already live in shared pages: their
            # writes go to the null page
            meta[4, r:r + count] = span < st["covered"]
            if start <= last < start + count:
                meta[3, r + last - start] = 1
                emit_row[s] = r + last - start
            r += count
        if abort is not None and abort.is_set():
            # set while admission and growth ran: yield here instead
            return self._finish_step(t0, before, tr)
        self._sync_ptab()
        self._shapes.add((T, self._gather))
        self.stats["decode_traces"] = len(self._shapes)
        self._same_step(meta, self._ptab[:, :self._gather])
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
        for s in decode_slots:
            req = self.active[s]
            d = drafts.get(s, ())
            # greedy acceptance: the base row's argmax is the true next
            # token; draft i's is valid iff d[0..i] matched the chain, so
            # take the longest matching prefix plus one bonus token
            b = base_row[s]
            accepted = [int(toks[b])]
            m = 0
            while m < len(d) and int(d[m]) == accepted[-1]:
                accepted.append(int(toks[b + 1 + m]))
                m += 1
            self.stats["spec_drafted"] += len(d)
            self.stats["spec_accepted"] += m
            # token by token, as without speculation: max_new, EOS and
            # capacity stop the chain mid-draft
            emitted, retired = 0, False
            for t in accepted:
                req.out.append(t)
                self._pos[s] += 1
                self._last[s] = t
                self.stats["decode_tokens"] += 1
                # count BEFORE a possible retire: finish_request seals
                # the span
                self.tracer.req_tokens(req.rid, 1)
                emitted += 1
                if self._prefix is not None and \
                        self._pos[s] % self.page_size == 0:
                    self._register_decode_block(s, req)
                hit_eos = self.eos_id is not None and t == self.eos_id
                if len(req.out) >= req.max_new or hit_eos or \
                        self._pos[s] >= self.max_len:
                    retired = True
                    break
            # the detail event first: retiring seals the span tree
            self.tracer.req_detail(req.rid, "decode", slot=s,
                                   tokens=emitted, drafted=len(d),
                                   accepted=m)
            if retired:
                self._retire(s)
            tr.note_decode(s, req.rid, emitted, drafted=len(d), accepted=m)
            if self.lazy and len(d) and self.active[s] is req:
                # rejection rollback: drop the draft pages past the
                # accepted cursor (a retired slot freed all its pages);
                # they are this step's extend-fresh private pages, so
                # shared prefix pages are never touched, and stale KV in
                # kept pages is masked by pos and overwritten
                dropped = self._alloc.rollback(s, int(self._pos[s]))
                if dropped:
                    w = len(self._alloc.pages_of(s))
                    self._ptab[s, w:w + len(dropped)] = 0
                    self._ptab_dirty = True
                self._note_pool()
        for s, start, count in allot:
            st = self._pf[s]
            st["cursor"] = start + count
            self.stats["prefill_chunk_tokens"] += count
            req = self.active[s]
            tr.note_chunk(s, req.rid, start, count)
            self.tracer.req_chunk_tokens(req.rid, count)
            self.tracer.req_detail(req.rid, "prefill_chunk", slot=s,
                                   start=start, count=count)
            if self._prefix is not None:
                # register only blocks the cursor has fully passed: no
                # later request (or cascade) may adopt an unwritten block
                aligned = st["cursor"] // self.page_size * self.page_size
                if aligned > 0:
                    self._prefix.insert(st["ctx"][:aligned],
                                        self._alloc.pages_of(s),
                                        salt=st["salt"])
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
        ``decode_traces``/``prefill_traces``/``encode_traces`` —
        program-shape counts over the engine's lifetime — and the backend
        name. Pool gauges restart from the current occupancy."""
        keep = ("decode_traces", "prefill_traces", "encode_traces",
                "decode_backend")
        for k, v in self.stats.items():
            if k not in keep:
                self.stats[k] = 0.0 if isinstance(v, float) else 0
        if self._prefix is not None:
            self._prefix.hit_blocks = 0
            self._prefix.miss_blocks = 0
            self._prefix.tail_hits = 0
        if self.paged:
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
