"""Llama-3.2-Vision-style VLM backbone — the port of
``repro/models/vlm.py``: a dense decoder where every ``cross_attn_every``
self-attention layers are followed by one gated cross-attention layer
over image patch embeddings [hf:Llama-3.2-Vision].

    G = num_layers // (cross_attn_every + 1) groups of
        [cross_attn_every x self layer] -> 1 cross layer
    + (num_layers - G (cross_attn_every + 1)) trailing self layers.

The ViT tower and projector are stubbed as in the reference:
``batch["image_embeds"]`` carries precomputed ``(B, num_image_tokens,
d_model)`` patch embeddings. Parameters are the nested dicts of
``params.py``: ``self_groups/*`` stacked ``(G, every, ...)``, ``cross/*``
``(G, ...)``, ``trailing/*`` ``(max(rest, 1), ...)`` (one unused layer
when ``rest == 0``, as the reference keeps); the stacks are Python loops
where the reference scans.

  forward(params, batch, cfg, remat=, attn_impl=)    -> logits, aux
  init_cache(cfg, batch, max_len, dtype=, device=, cp=) -> cache
  prefill(params, batch, cfg, cache, attn_impl=)     -> last logits, cache
  decode_step(params, cache, token, pos, cfg)        -> logits, cache

A cross layer adds ``tanh(gate_attn)`` times its cross-attention and
``tanh(gate_mlp)`` times its MLP to the residual (each gate in fp32, cast
to the activations' dtype): at init both gates are 0 and the images do
not move the logits, as in the source model. Self-attention goes through
``layers.attention`` (on a CUDA tensor ``forward`` and ``prefill`` run the
flash kernel; decode on dense rows is plain attention with per-row
masks, as in the reference); cross-attention is the reference's
``impl="full"``, plain attention outside any kernel on either device,
under the profiler range :data:`CROSS_RANGE` with its image K/V
projections. Every MLP is the SwiGLU of ``layers.mlp`` (the fused kernel
on a CUDA tensor when no gradient is required). ``forward(remat=True)``
checkpoints each whole group (its self layers and its cross layer) with
``tp.checkpoint``; the trailing layers are not rematerialised.

The cache is ``{"kv_g": {"k", "v": (G * every, B, W, Hkv, D)}, "kv_t":
the same over max(rest, 1) layers, "xkv": {"k", "v": (G, B,
num_image_tokens, Hkv, D)}, "pos"}`` with ``W = transformer.cache_window(
cfg, max_len)`` (the ring of the window on sliding-window configs).
``prefill`` and ``decode_step`` write it IN PLACE, as the port's other
families do: the serve engine hands ``prefill`` one slot's row views. The
family is not pageable (the reference serves it on the dense layout
only).

Under a tensor-parallel mesh (``core/tp.py``, made current by the serving
engine and the trainer) every function runs on the rank's shards, as
``models/encdec.py``'s decoder does: the rank's query heads of every self
and cross layer (the head counts are the projections' own), its K/V
heads (all of them where Hkv does not divide tp, its query heads reading
theirs, ``tp.kv_read``), its column blocks of each MLP and its
vocabulary rows. A self layer ends in the ``attn_out`` and ``mlp_out``
sums, and so does a cross layer; the images are whole on every "model"
rank, and each cross layer's image K/V holds the rank's K/V heads. The
dense cache follows the reference's ``cache_pspecs`` (``tp.cache_rows``),
the self rows and the image K/V each on its own: where Hkv does not
divide tp and the positions do (or, for the self rows, under
``cfg.cp_decode``), a rank holds every head over its slice of the
positions, with ``"kv_slice"`` / ``"xkv_slice"``; ``prefill`` fills the
slices and ``decode_step`` attends over them context-parallel.

``forward`` trains on a ("data", "model") mesh (``train/step.py``): each
column-parallel region starts with ``tp.region_in`` (self-attention's
QKV, the cross query, every MLP), the image K/V projection sums the
gradient of ``wk``/``wv`` where they are whole (``"kv_proj"``; the images
are data, with no gradient to sum); the stacks come through
``tp.layer_sources`` (FSDP gathers a group, a cross layer or a trailing
layer when it is applied, inside the checkpoint under remat). Under
sequence parallelism the residual stream is the rank's slice of the
tokens, the norms' scales and the two gates are under ``tp.enter`` (each
scales only the rank's slice, so its gradient is a partial: ``"norm"``,
``"gate"``); without it the gated outputs are whole on every rank and the
gates' gradients are not summed.
"""
from __future__ import annotations

import torch
from torch.profiler import record_function

from repro_torch.core import tp
from repro_torch.models import cp_attention, kvcache
from repro_torch.models.encdec import cross_kv, cross_out
from repro_torch.models.layers import (attention, attn_out, attn_qkv, mlp,
                                       rmsnorm)
from repro_torch.models.transformer import (_embed, _fill, _head, _is_ring,
                                            block, cache_window, unstack)

#: the ``record_function`` range the cross layers' attention (and their
#: image K/V projections) run under, so a profile splits their device
#: time out
CROSS_RANGE = "vlm_cross"


def _image_kv(cp, img, cfg):
    """One cross layer's K/V of the image embeddings, (B, N, Hkv, D) (the
    rank's K/V heads, or all of them where Hkv does not divide tp)."""
    with record_function(CROSS_RANGE):
        return cross_kv(cp, img, cfg)


def _gate(cp, key: str, x, sp: bool):
    """``tanh`` of a cross layer's gate in the activations' dtype. Under
    sequence parallelism (``sp``) it scales the rank's slice of the
    sequence, so its gradient there is a partial: summed over "model"
    (``"gate"``). Without it the gated output is whole on every rank and
    so is the gate's gradient: no sum."""
    gate = tp.enter(cp[key], "gate") if sp else cp[key]
    return torch.tanh(gate).to(x.dtype)


def _cross_block(cp, x, img_kv, cfg, *, sp: bool = False, rows=None):
    """Gated cross-attention over the image K/V, then the gated MLP, on
    the rank's query heads and MLP block (``sp``: ``x`` the rank's slice
    of the sequence); ``rows`` (a ``tp.SeqSlice``): the image K/V are the
    rank's slice of the image positions with every head, attended
    context-parallel."""
    with record_function(CROSS_RANGE):
        x = x + _gate(cp, "gate_attn", x, sp) * cross_out(
            cp, x, img_kv, cfg, sp=sp, rows=rows)
    ln2 = tp.enter(cp["ln2"], "norm") if sp else cp["ln2"]
    h = tp.region_in(rmsnorm(x, ln2, cfg.norm_eps), "mlp", seq=sp)
    return x + _gate(cp, "gate_mlp", x, sp) * mlp(cp["mlp"], h, sp=sp)


def _images(batch, cfg, dtype):
    if "image_embeds" not in batch:
        raise KeyError(
            f"image_embeds: {cfg.name} is a VLM; its batches carry "
            "'image_embeds' (B, num_image_tokens, d_model) beside 'tokens' "
            "(train it on a data= object whose batch(step) yields them)")
    return batch["image_embeds"].to(dtype)


def _group(slp, cp, x, img, cfg, attn_impl, sp):
    """``every`` self layers, then the group's cross layer."""
    for lp in unstack(slp, cfg.cross_attn_every):
        x = block(lp, x, cfg, attn_impl=attn_impl, sp=sp)[0]
    return _cross_block(cp, x, _image_kv(cp, img, cfg), cfg, sp=sp)


def forward(params, batch, cfg, *, remat: bool = False,
            attn_impl: str = "auto"):
    """batch: {"tokens": (B, S), "image_embeds": (B, N, d)} -> (logits
    (B, S, V), aux 0). A batch without images raises ``KeyError`` here, as
    the reference's forward does (its token dataset yields tokens
    only). Under a rank each rank runs its shards (module docstring)."""
    sp = tp.seq_parallel(batch["tokens"].shape[1])
    x = _embed(params, batch["tokens"], cfg, sp=sp)
    img = _images(batch, cfg, x.dtype)
    g, rest = cfg.vlm_groups
    for selfs, cross in zip(
            tp.layer_sources(params["self_groups"], g, "self_groups"),
            tp.layer_sources(params["cross"], g, "cross")):
        def run(y, i, selfs=selfs, cross=cross):
            return _group(selfs(), cross(), y, i, cfg, attn_impl, sp)
        x = tp.checkpoint(run, x, img) if remat else run(x, img)
    if rest:
        for layer in tp.layer_sources(params["trailing"], rest, "trailing"):
            x = block(layer(), x, cfg, attn_impl=attn_impl, sp=sp)[0]
    return _head(params, x, cfg, sp=sp), \
        torch.zeros((), dtype=torch.float32, device=x.device)


def init_cache(cfg, batch: int, max_len: int, dtype=None, device=None, *,
               cp=None):
    """Zero self-attention K/V rows (``cache_window(cfg, max_len)`` long)
    for every self layer (the unused trailing one too), zero image K/V
    blocks for every cross layer, and a scalar cursor. Under a live rank
    each is the rank's rows (``tp.cache_rows``, the reference's
    ``cache_pspecs``; ``cp``, default ``cfg.cp_decode``, asks for the
    sequence slice of self rows that are no ring), with ``"kv_slice"`` /
    ``"xkv_slice"`` where they are a slice of the positions."""
    dtype = dtype or cfg.dtype
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    g, rest = cfg.vlm_groups
    w = cache_window(cfg, max_len)
    cp = cfg.cp_decode if cp is None else cp
    heads, sl = tp.cache_rows(cfg, w, ring=_is_ring(cfg, w), cp=cp)
    xheads, xsl = tp.cache_rows(cfg, cfg.num_image_tokens, ring=False,
                                cp=False)

    def stack(n, length, h, part):
        # every layer's rows in one allocation, the leading axis a view
        rows = kvcache.init_kv(n * batch, length if part is None
                               else part.length, h, cfg.head_dim, dtype,
                               device)
        return {k: a.view(n, batch, *a.shape[1:]) for k, a in rows.items()}

    cache = {"kv_g": stack(g * cfg.cross_attn_every, w, heads, sl),
             "kv_t": stack(max(rest, 1), w, heads, sl),
             "xkv": stack(g, cfg.num_image_tokens, xheads, xsl),
             "pos": torch.zeros((), dtype=torch.int32, device=device)}
    if sl is not None:
        cache["kv_slice"] = sl
    if xsl is not None:
        cache["xkv_slice"] = xsl
    return cache


def _prefill_layer(lp, x, cfg, kv, i: int, attn_impl, w: int, sl):
    """One self layer over the prompt; its K/V go to layer ``i`` of
    ``kv`` (``transformer._fill``: the rank's slice ``sl`` of them where
    the rows are one)."""
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = attn_qkv(lp["attn"], h, cfg)
    ctx = attention(q, tp.kv_read(k), tp.kv_read(v), causal=True,
                    window=cfg.sliding_window, impl=attn_impl)
    x = x + attn_out(lp["attn"], ctx, cfg)
    x = x + mlp(lp["mlp"], rmsnorm(x, lp["ln2"], cfg.norm_eps))
    _fill(kv, i, k, v, w, sl)
    return x


def prefill(params, batch, cfg, cache, *, attn_impl: str = "auto"):
    """Run the whole prompt (never padded: no ``last_pos``), fill
    ``cache`` in place — every self layer's K/V, every cross layer's image
    K/V (the rank's slice of each where the cache holds one), ``kv_t``
    zeroed when there are no trailing layers — and return the last
    token's logits (B, 1, V)."""
    tokens = batch["tokens"]
    x = _embed(params, tokens, cfg)
    img = _images(batch, cfg, x.dtype)
    g, rest = cfg.vlm_groups
    e = cfg.cross_attn_every
    sl, xsl = cache.get("kv_slice"), cache.get("xkv_slice")
    w = cache["kv_g"]["k"].shape[2] if sl is None else sl.total
    for gi, (slp, cp) in enumerate(zip(unstack(params["self_groups"], g),
                                       unstack(params["cross"], g))):
        for j, lp in enumerate(unstack(slp, e)):
            x = _prefill_layer(lp, x, cfg, cache["kv_g"], gi * e + j,
                               attn_impl, w, sl)
        ikv = _image_kv(cp, img, cfg)
        x = _cross_block(cp, x, ikv, cfg)
        _fill(cache["xkv"], gi, ikv["k"], ikv["v"], cfg.num_image_tokens,
              xsl)
    if rest:
        for i, lp in enumerate(unstack(params["trailing"], rest)):
            x = _prefill_layer(lp, x, cfg, cache["kv_t"], i, attn_impl, w,
                               sl)
    else:
        for leaf in cache["kv_t"].values():
            leaf.zero_()
    cache["pos"] = torch.tensor(tokens.shape[1], dtype=torch.int32,
                                device=x.device)
    return _head(params, x[:, -1:], cfg), cache


def decode_step(params, cache, token, pos, cfg):
    """token: (B, 1) int; ``pos``: scalar (the lockstep loop) or (B,)
    per-row cursors (the engine's slot table). Each self layer writes its
    K/V at the row's cursor (``pos % W`` on the ring) and attends to its
    valid prefix, ``kv_len = min(pos + 1, W)``, or through
    ``kvcache.ring_kpos`` on the ring; each cross layer attends to its
    image K/V. On the rank's sequence slices (``"kv_slice"``,
    ``"xkv_slice"``) the attention is context-parallel
    (``models/cp_attention.py``: the reference's ``use_cp`` branch for a
    scalar ``pos``, and the engine's per-row cursors). Returns (logits
    (B, 1, V), cache) with the K/V updated in place and ``"pos"``
    advanced."""
    x = _embed(params, token, cfg)
    g, rest = cfg.vlm_groups
    e = cfg.cross_attn_every
    sl, xsl = cache.get("kv_slice"), cache.get("xkv_slice")
    w = cache["kv_g"]["k"].shape[2] if sl is None else sl.total
    ring = _is_ring(cfg, w)
    pos = torch.as_tensor(pos, device=x.device).to(torch.int32)
    batched = pos.ndim > 0
    positions = pos[:, None] if batched else pos.expand(token.shape[0], 1)
    kpos = kvcache.ring_kpos(positions, w) if ring else None
    kv_len = None if ring else torch.clamp(pos + 1, max=w)

    def self_layer(lp, x, stack, i):
        h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = attn_qkv(lp["attn"], h, cfg, positions=positions)
        kv = {"k": stack["k"][i], "v": stack["v"][i]}
        if sl is not None:
            ctx = cp_attention.cp_decode_attention(
                q, kv, k, v, pos, window=cfg.sliding_window, rows=sl,
                ring=ring)
        else:
            kvcache.write_kv(kv, k, v, pos, ring=ring, window=w)
            ctx = attention(q, tp.kv_read(kv["k"]), tp.kv_read(kv["v"]),
                            causal=True, window=cfg.sliding_window,
                            q_offset=pos, kv_len=kv_len, kpos=kpos)
        x = x + attn_out(lp["attn"], ctx, cfg)
        return x + mlp(lp["mlp"], rmsnorm(x, lp["ln2"], cfg.norm_eps))

    xkv = cache["xkv"]
    for gi, (slp, cp) in enumerate(zip(unstack(params["self_groups"], g),
                                       unstack(params["cross"], g))):
        for j, lp in enumerate(unstack(slp, e)):
            x = self_layer(lp, x, cache["kv_g"], gi * e + j)
        x = _cross_block(cp, x, {"k": xkv["k"][gi], "v": xkv["v"][gi]}, cfg,
                         rows=xsl)
    if rest:
        for i, lp in enumerate(unstack(params["trailing"], rest)):
            x = self_layer(lp, x, cache["kv_t"], i)
    cache["pos"] = pos + 1
    return _head(params, x, cfg), cache
