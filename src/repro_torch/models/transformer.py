"""Decoder-only transformer LM (llama-style: dense SwiGLU FFN, or the MoE
FFN of models/moe.py on an MoE config) — the port of
``repro/models/transformer.py``.

Parameters are nested dicts of tensors with the JAX tree's keys and the
per-layer weights stacked on a leading L axis (``params.py``); the layer
stack is a Python loop over that axis where the reference scans.

  forward(params, batch, cfg, remat=, attn_impl=)         -> logits, aux
  init_cache(cfg, batch, max_len, dtype=, device=)        -> cache
  prefill(params, batch, cfg, cache, attn_impl=, last_pos=) -> logits, cache
  decode_step(params, cache, token, pos, cfg)             -> logits, cache

``forward`` trains: ``remat=True`` wraps each layer in
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of the scan
body; the checkpointed layer returns its router aux loss too), its aux is
the layers' router load-balance losses summed (0 for a dense FFN), and
``attn_impl`` picks the attention path (``layers.attention``:
on a CUDA tensor ``auto`` and ``pallas`` run the flash kernel, so every
prefill does too, windowed on sliding-window configs).

The cache is updated IN PLACE by ``prefill`` and ``decode_step`` (the
reference returns new arrays). Its layouts (models/kvcache.py):

* dense ``{"kv": (L, B, W, Hkv, D) leaves, "pos"}``, ``W = max_len``, or
  the ring of ``W = sliding_window`` rows on sliding-window configs;
  decode attends through ``layers.attention_full`` with per-row masks
  (the reference computes it in XLA, not in a Pallas kernel);
* paged ``{"kv": (L, n_pages, page_size, Hkv, D) pool, "ptab"[, "wtab"]}``:
  every row's K/V is scattered through ``wtab`` (default ``ptab``) before
  any row attends through ``ptab`` with the paged-attention kernel — the
  serve engine's mixed token-slot program and its split decode.

An MoE layer routes all the rows of one call together: ``prefill`` the
prompt's tokens, ``decode_step`` its B rows (the mixed step's pads and the
split path's inactive slots included, as in the reference), each expert
with the capacity of that many tokens; ``prefill`` and ``decode_step``
drop the aux loss.

Under a tensor-parallel mesh (``core/tp.py``, made current by the serving
engine) ``prefill`` and ``decode_step`` run on the rank's shards: its
query heads, its K/V heads (all of them where Hkv does not divide tp,
its query heads then reading theirs), its column blocks of the MLP and
its vocabulary rows — the embedding is a vocab-parallel lookup and the
logits are assembled to the full vocabulary. ``init_cache`` then gives
the rank's rows of the dense cache (``tp.cache_rows``, the reference's
``cache_pspecs``): where they are a SEQUENCE slice of every K/V head
(Hkv does not divide tp, or ``cfg.cp_decode``), the cache carries its
``tp.SeqSlice`` under ``"kv_slice"``, ``prefill`` fills the slice and
``decode_step`` takes the context-parallel branch
(``models/cp_attention.py``: the reference's ``cp_decode`` path for a
scalar ``pos``, and the engine's per-row cursors). Without a rank, or
at tp 1, ``cfg.cp_decode`` changes nothing, as the reference's
``cp_available`` is False there. ``forward`` trains under a rank on a
("data", "model") mesh (``train/step.py``): Megatron's heads, MLP
blocks, experts and vocabulary over "model", sequence parallelism and
FSDP's layer gathers as the rank's strategy says (``core/tp.py``).
"""
from __future__ import annotations

import torch
from repro_torch.core import tp
from repro_torch.models import cp_attention, kvcache, moe as moe_lib
from repro_torch.models.layers import (attention, attn_out, attn_qkv, mlp,
                                       paged_attention, rmsnorm)
from repro_torch.tree import unbind_leaves, unflatten


def layer_params(params, i: int):
    """Layer ``i``'s weights: a view into the stacked L axis."""
    def pick(tree):
        return {k: pick(v) if isinstance(v, dict) else v[i]
                for k, v in tree.items()}
    return pick(params["layers"])


def unstack(tree, n: int):
    """The ``n`` views along the leading axis of every leaf of ``tree``
    (``tree.unbind_leaves``: one ``unbind`` a leaf)."""
    parts = unbind_leaves(tree)
    return [unflatten({k: p[i] for k, p in parts.items()})
            for i in range(n)]


def unstack_layers(params, n: int):
    """Per-layer views of the stacked L axis (:func:`unstack`)."""
    return unstack(params["layers"], n)


def _embed(params, tokens, cfg, *, sp: bool = False):
    table = tp.fsdp_full(params["embed"], "embed")
    return tp.vocab_embed(table, tokens, cfg.vocab_size, seq=sp).to(
        getattr(torch, cfg.dtype))


def _head(params, x, cfg, *, sp: bool = False):
    """The final norm and the (vocab-parallel) head. ``sp``: ``x`` is the
    rank's sequence slice, gathered after the norm."""
    scale = tp.fsdp_full(params["final_norm"], "final_norm")
    x = rmsnorm(x, tp.enter(scale, "norm") if sp else scale, cfg.norm_eps)
    if sp:
        x = tp.seq_gather(x, "head_seq")
    w = tp.fsdp_full(params["lm_head"], "lm_head") if "lm_head" in params \
        else tp.fsdp_full(params["embed"], "embed").T
    if w.shape[-1] != cfg.vocab_size:
        x = tp.enter(x, "head_in")
    return tp.vocab_logits(x @ w, cfg.vocab_size)


def ffn(lp, h, cfg, *, sp: bool = False):
    """The layer's FFN on ``h``: (y, router aux loss) on an MoE config,
    (y, None) for the dense SwiGLU. ``sp``: ``h`` is the rank's sequence
    slice, and so is ``y``."""
    if cfg.is_moe:
        return moe_lib.moe_ffn(lp["moe"], h, cfg, sp=sp)
    return mlp(lp["mlp"], tp.region_in(h, "mlp", seq=sp), sp=sp), None


def block(lp, x, cfg, *, attn_impl: str = "auto", sp: bool = False):
    """Pre-norm attention + pre-norm FFN over a whole sequence. Returns
    (y, aux): the MoE router's aux loss, None for a dense FFN. Under a
    rank the projections are the rank's heads and blocks (``tp``'s f and
    g around them); ``sp``: ``x`` and ``y`` are the rank's slice of the
    sequence, gathered before each column-parallel region and
    reduce-scattered after each row-parallel one, the norms applied to
    the slice."""
    ln1, ln2 = lp["ln1"], lp["ln2"]
    if sp:
        ln1, ln2 = tp.enter(ln1, "norm"), tp.enter(ln2, "norm")
    h = tp.region_in(rmsnorm(x, ln1, cfg.norm_eps), "attn", seq=sp)
    q, k, v = attn_qkv(lp["attn"], h, cfg)
    ctx = attention(q, tp.kv_read(k), tp.kv_read(v), causal=True,
                    window=cfg.sliding_window, impl=attn_impl)
    x = x + attn_out(lp["attn"], ctx, cfg, sp=sp)
    y, aux = ffn(lp, rmsnorm(x, ln2, cfg.norm_eps), cfg, sp=sp)
    return x + y, aux


def forward(params, batch, cfg, *, remat: bool = False,
            attn_impl: str = "auto"):
    """batch: {"tokens": (B,S) int}. Returns (logits (B,S,V), aux): the
    layers' router aux losses summed, 0 for a dense FFN. Under a rank
    (``tp.active``) each rank runs its shards; FSDP's layers are gathered
    one at a time inside the checkpoint (``tp.layer_sources``), and
    under sequence parallelism the residual stream is the rank's slice
    of the sequence."""
    sp = tp.seq_parallel(batch["tokens"].shape[1])
    x = _embed(params, batch["tokens"], cfg, sp=sp)
    auxs = []
    for layer in tp.layer_sources(params["layers"], cfg.num_layers,
                                  "layers"):
        def run(y, layer=layer):
            return block(layer(), y, cfg, attn_impl=attn_impl, sp=sp)
        x, aux = tp.checkpoint(run, x) if remat else run(x)
        auxs.append(aux)
    aux = torch.stack(auxs).sum() if cfg.is_moe else \
        torch.zeros((), dtype=torch.float32, device=x.device)
    return _head(params, x, cfg, sp=sp), aux


def cache_window(cfg, max_len: int) -> int:
    """Ring length: sliding-window configs hold only the window."""
    if cfg.sliding_window > 0:
        return min(max_len, cfg.sliding_window)
    return max_len


def init_cache(cfg, batch: int, max_len: int, dtype=None, device=None, *,
               cp=None):
    """Zero dense (or ring) KV for ``batch`` rows and a scalar cursor.
    Under a live rank: the rank's rows (``tp.cache_rows``; ``cp``,
    default ``cfg.cp_decode``, asks for the sequence slice of a cache
    that is no ring), with ``"kv_slice"`` where they are a slice."""
    dtype = dtype or cfg.dtype
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    w = cache_window(cfg, max_len)
    heads, sl = tp.cache_rows(cfg, w, ring=_is_ring(cfg, w),
                              cp=cfg.cp_decode if cp is None else cp)
    # every layer's rows in one allocation, the leading L axis a view
    rows = kvcache.init_kv(cfg.num_layers * batch,
                           w if sl is None else sl.length, heads,
                           cfg.head_dim, dtype, device)
    cache = {"kv": {k: a.view(cfg.num_layers, batch, *a.shape[1:])
                    for k, a in rows.items()},
             "pos": torch.zeros((), dtype=torch.int32, device=device)}
    if sl is not None:
        cache["kv_slice"] = sl
    return cache


def _is_ring(cfg, w: int) -> bool:
    return cfg.sliding_window > 0 and w == cfg.sliding_window


def _fill(kv, i: int, k, v, w: int, sl):
    """Layer ``i``'s prefill K/V into the cache (``kvcache.fit_prefill``),
    or into the rank's slice ``sl`` of it: every K/V head, assembled
    over the group by one zero-filled sum where the rank computed only
    its own (``"prefill_kv"``)."""
    if sl is not None:
        k, v = tp.gather_heads([k, v], [kv["k"].shape[3]] * 2,
                               "prefill_kv")
    for key, new in (("k", k), ("v", v)):
        new = kvcache.fit_prefill(new, w)
        kv[key][i] = new if sl is None else \
            new[:, sl.start:sl.start + sl.length]


def prefill(params, batch, cfg, cache, *, attn_impl: str = "auto",
            last_pos=None):
    """Run the whole prompt, fill ``cache`` in place (each layer's K/V
    through ``kvcache.fit_prefill``: a ring keeps the last ``window``
    positions) and return the last token's logits (B, 1, V).

    ``last_pos`` (scalar or (B,)): index of the last REAL token of a
    prompt right-padded to a bucket; logits are gathered there. Padding
    rows are causally invisible to real rows, and their cache entries stay
    masked by ``kv_len`` / ``kpos`` until decode overwrites them.
    """
    tokens = batch["tokens"]
    b, s = tokens.shape
    kv = cache["kv"]
    sl = cache.get("kv_slice")
    w = kv["k"].shape[2] if sl is None else sl.total
    x = _embed(params, tokens, cfg)
    for i, lp in enumerate(unstack_layers(params, cfg.num_layers)):
        h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = attn_qkv(lp["attn"], h, cfg)
        ctx = attention(q, tp.kv_read(k), tp.kv_read(v), causal=True,
                        window=cfg.sliding_window, impl=attn_impl)
        x = x + attn_out(lp["attn"], ctx, cfg)
        x = x + ffn(lp, rmsnorm(x, lp["ln2"], cfg.norm_eps), cfg)[0]
        _fill(kv, i, k, v, w, sl)
    cache["pos"] = torch.tensor(s, dtype=torch.int32, device=x.device)
    if last_pos is None:
        return _head(params, x[:, -1:], cfg), cache
    last = torch.as_tensor(last_pos, device=x.device).long().expand(b)
    x = x[torch.arange(b, device=x.device), last][:, None]
    return _head(params, x, cfg), cache


def decode_step(params, cache, token, pos, cfg):
    """token: (B,1) int; pos: scalar (the lockstep loop: tokens so far) or
    (B,) per-row cursors (the engine's slot table). A cache with a
    ``"ptab"`` takes the paged branch: every row's K/V is scattered
    through ``cache.get("wtab", cache["ptab"])`` BEFORE any row attends
    through ``cache["ptab"]`` — which is what makes chunked prefill exact:
    a chunk's rows see each other's K/V. Otherwise the dense or ring
    cache: each row writes at its cursor (``pos % W`` on the ring) and
    attends to its own valid prefix; a cache whose rows are the rank's
    sequence slice (``"kv_slice"``) goes through
    ``cp_attention.cp_decode_attention``. Returns (logits (B,1,V), cache)
    with ``cache["kv"]`` updated in place and ``"pos"`` advanced."""
    x = _embed(params, token, cfg)
    paged = "ptab" in cache
    pool = cache["kv"]
    pos = torch.as_tensor(pos, device=x.device).to(torch.int32)
    batched = pos.ndim > 0
    positions = pos[:, None] if batched else pos.expand(token.shape[0], 1)
    sl = cache.get("kv_slice")
    if paged:
        ptab = cache["ptab"]
        wtab = cache.get("wtab", ptab)
        rows = pos if batched else positions[:, 0].contiguous()
    else:
        w = pool["k"].shape[2] if sl is None else sl.total
        ring = _is_ring(cfg, w)
        kpos = kvcache.ring_kpos(positions, w) if ring else None
        kv_len = None if ring else torch.clamp(pos + 1, max=w)
    for i in range(cfg.num_layers):
        lp = layer_params(params, i)
        h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = attn_qkv(lp["attn"], h, cfg, positions=positions)
        kv = {"k": pool["k"][i], "v": pool["v"][i]}
        if paged:
            kvcache.write_kv_paged(kv, k, v, wtab, rows)
            ctx = paged_attention(q, tp.kv_read(kv["k"]),
                                  tp.kv_read(kv["v"]), ptab, rows)
        elif sl is not None:
            ctx = cp_attention.cp_decode_attention(
                q, kv, k, v, pos, window=cfg.sliding_window, rows=sl,
                ring=ring)
        else:
            kvcache.write_kv(kv, k, v, pos, ring=ring, window=w)
            ctx = attention(q, tp.kv_read(kv["k"]), tp.kv_read(kv["v"]),
                            causal=True, window=cfg.sliding_window,
                            q_offset=pos, kv_len=kv_len, kpos=kpos)
        x = x + attn_out(lp["attn"], ctx, cfg)
        x = x + ffn(lp, rmsnorm(x, lp["ln2"], cfg.norm_eps), cfg)[0]
    out = {"kv": pool, "pos": pos + 1}
    for key in ("ptab", "kv_slice"):
        if key in cache:
            out[key] = cache[key]
    return _head(params, x, cfg), out
