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
  init_cache(cfg, batch, max_len, dtype=, device=)   -> cache
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
``torch.utils.checkpoint``; the trailing layers are not rematerialised.

The cache is ``{"kv_g": {"k", "v": (G * every, B, W, Hkv, D)}, "kv_t":
the same over max(rest, 1) layers, "xkv": {"k", "v": (G, B,
num_image_tokens, Hkv, D)}, "pos"}`` with ``W = transformer.cache_window(
cfg, max_len)`` (the ring of the window on sliding-window configs).
``prefill`` and ``decode_step`` write it IN PLACE, as the port's other
families do: the serve engine hands ``prefill`` one slot's row views. The
family is not pageable (the reference serves it on the dense layout
only).
"""
from __future__ import annotations

import torch
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from repro_torch.core import tp
from repro_torch.models import kvcache
from repro_torch.models.encdec import cross_kv
from repro_torch.models.layers import (attention, attn_out, attn_qkv, mlp,
                                       rmsnorm)
from repro_torch.models.transformer import (_embed, _head, block,
                                            cache_window, unstack)

#: the ``record_function`` range the cross layers' attention (and their
#: image K/V projections) run under, so a profile splits their device
#: time out
CROSS_RANGE = "vlm_cross"


def _image_kv(cp, img, cfg):
    """One cross layer's K/V of the image embeddings, (B, N, Hkv, D)."""
    with record_function(CROSS_RANGE):
        return cross_kv(cp, img, cfg)


def _cross_block(cp, x, img_kv, cfg):
    """Gated cross-attention over the image K/V, then the gated MLP."""
    with record_function(CROSS_RANGE):
        h = rmsnorm(x, cp["lnx"], cfg.norm_eps)
        b, s, _ = h.shape
        q = (h @ cp["xattn"]["wq"]).reshape(b, s, cfg.num_heads,
                                            cfg.head_dim)
        ctx = attention(q, img_kv["k"], img_kv["v"], causal=False,
                        impl="full")
        x = x + (torch.tanh(cp["gate_attn"]).to(x.dtype)
                 * attn_out(cp["xattn"], ctx, cfg))
    h = rmsnorm(x, cp["ln2"], cfg.norm_eps)
    return x + torch.tanh(cp["gate_mlp"]).to(x.dtype) * mlp(cp["mlp"], h)


def _images(batch, cfg, dtype):
    if "image_embeds" not in batch:
        raise KeyError(
            f"image_embeds: {cfg.name} is a VLM; its batches carry "
            "'image_embeds' (B, num_image_tokens, d_model) beside 'tokens' "
            "(train it on a data= object whose batch(step) yields them)")
    return batch["image_embeds"].to(dtype)


def _group(slp, cp, x, img, cfg, attn_impl):
    """``every`` self layers, then the group's cross layer."""
    for lp in unstack(slp, cfg.cross_attn_every):
        x = block(lp, x, cfg, attn_impl=attn_impl)[0]
    return _cross_block(cp, x, _image_kv(cp, img, cfg), cfg)


def forward(params, batch, cfg, *, remat: bool = False,
            attn_impl: str = "auto"):
    """batch: {"tokens": (B, S), "image_embeds": (B, N, d)} -> (logits
    (B, S, V), aux 0). A batch without images raises ``KeyError`` here, as
    the reference's forward does (its token dataset yields tokens
    only)."""
    tp.check_training("vlm.forward", tp.FAMILY_STEP)
    x = _embed(params, batch["tokens"], cfg)
    img = _images(batch, cfg, x.dtype)
    g, rest = cfg.vlm_groups
    for slp, cp in zip(unstack(params["self_groups"], g),
                       unstack(params["cross"], g)):
        if remat:
            x = checkpoint(lambda y, i, slp=slp, cp=cp: _group(
                slp, cp, y, i, cfg, attn_impl), x, img, use_reentrant=False)
        else:
            x = _group(slp, cp, x, img, cfg, attn_impl)
    if rest:
        for lp in unstack(params["trailing"], rest):
            x = block(lp, x, cfg, attn_impl=attn_impl)[0]
    return _head(params, x, cfg), \
        torch.zeros((), dtype=torch.float32, device=x.device)


def init_cache(cfg, batch: int, max_len: int, dtype=None, device=None):
    """Zero self-attention K/V rows (``cache_window(cfg, max_len)`` long)
    for every self layer (the unused trailing one too), zero image K/V
    blocks for every cross layer, and a scalar cursor."""
    dtype = dtype or cfg.dtype
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    g, rest = cfg.vlm_groups
    w = cache_window(cfg, max_len)

    def stack(n, length):
        # every layer's rows in one allocation, the leading axis a view
        rows = kvcache.init_kv(n * batch, length, cfg.num_kv_heads,
                               cfg.head_dim, dtype, device)
        return {k: a.view(n, batch, *a.shape[1:]) for k, a in rows.items()}

    return {"kv_g": stack(g * cfg.cross_attn_every, w),
            "kv_t": stack(max(rest, 1), w),
            "xkv": stack(g, cfg.num_image_tokens),
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def _prefill_layer(lp, x, cfg, kv, i: int, attn_impl):
    """One self layer over the prompt; its K/V go to layer ``i`` of
    ``kv`` through ``kvcache.fit_prefill``."""
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = attn_qkv(lp["attn"], h, cfg)
    ctx = attention(q, k, v, causal=True, window=cfg.sliding_window,
                    impl=attn_impl)
    x = x + attn_out(lp["attn"], ctx, cfg)
    x = x + mlp(lp["mlp"], rmsnorm(x, lp["ln2"], cfg.norm_eps))
    w = kv["k"].shape[2]
    kv["k"][i] = kvcache.fit_prefill(k, w)
    kv["v"][i] = kvcache.fit_prefill(v, w)
    return x


def _check_unsharded(what: str):
    """Raise ``NotImplementedError`` naming item 11 under a live rank:
    the VLM's layers do not run on a rank's shards yet."""
    r = tp.current()
    if r is not None and r.tp > 1:
        raise NotImplementedError(
            f"{what} under a tensor-parallel rank waits for ROADMAP.md "
            f"Queue 1 item 11, step {tp.FAMILY_STEP}")


def prefill(params, batch, cfg, cache, *, attn_impl: str = "auto"):
    """Run the whole prompt (never padded: no ``last_pos``), fill
    ``cache`` in place — every self layer's K/V, every cross layer's image
    K/V, ``kv_t`` zeroed when there are no trailing layers — and return
    the last token's logits (B, 1, V)."""
    _check_unsharded("vlm.prefill")
    tokens = batch["tokens"]
    x = _embed(params, tokens, cfg)
    img = _images(batch, cfg, x.dtype)
    g, rest = cfg.vlm_groups
    e = cfg.cross_attn_every
    xkv = cache["xkv"]
    for gi, (slp, cp) in enumerate(zip(unstack(params["self_groups"], g),
                                       unstack(params["cross"], g))):
        for j, lp in enumerate(unstack(slp, e)):
            x = _prefill_layer(lp, x, cfg, cache["kv_g"], gi * e + j,
                               attn_impl)
        ikv = _image_kv(cp, img, cfg)
        x = _cross_block(cp, x, ikv, cfg)
        xkv["k"][gi] = ikv["k"]
        xkv["v"][gi] = ikv["v"]
    if rest:
        for i, lp in enumerate(unstack(params["trailing"], rest)):
            x = _prefill_layer(lp, x, cfg, cache["kv_t"], i, attn_impl)
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
    image K/V. Without a rank ``cfg.cp_decode`` changes nothing (the
    reference's ``cp_available`` is False there); under a live rank the
    call raises, naming item 11. Returns (logits (B, 1, V), cache)
    with the K/V updated in place and ``"pos"`` advanced."""
    _check_unsharded("vlm.decode_step")
    x = _embed(params, token, cfg)
    g, rest = cfg.vlm_groups
    e = cfg.cross_attn_every
    w = cache["kv_g"]["k"].shape[2]
    ring = cfg.sliding_window > 0 and w == cfg.sliding_window
    pos = torch.as_tensor(pos, device=x.device).to(torch.int32)
    batched = pos.ndim > 0
    positions = pos[:, None] if batched else pos.expand(token.shape[0], 1)
    kpos = kvcache.ring_kpos(positions, w) if ring else None
    kv_len = None if ring else torch.clamp(pos + 1, max=w)

    def self_layer(lp, x, stack, i):
        h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = attn_qkv(lp["attn"], h, cfg, positions=positions)
        kv = {"k": stack["k"][i], "v": stack["v"][i]}
        kvcache.write_kv(kv, k, v, pos, ring=ring, window=w)
        ctx = attention(q, kv["k"], kv["v"], causal=True,
                        window=cfg.sliding_window, q_offset=pos,
                        kv_len=kv_len, kpos=kpos)
        x = x + attn_out(lp["attn"], ctx, cfg)
        return x + mlp(lp["mlp"], rmsnorm(x, lp["ln2"], cfg.norm_eps))

    xkv = cache["xkv"]
    for gi, (slp, cp) in enumerate(zip(unstack(params["self_groups"], g),
                                       unstack(params["cross"], g))):
        for j, lp in enumerate(unstack(slp, e)):
            x = self_layer(lp, x, cache["kv_g"], gi * e + j)
        x = _cross_block(cp, x, {"k": xkv["k"][gi], "v": xkv["v"][gi]}, cfg)
    if rest:
        for i, lp in enumerate(unstack(params["trailing"], rest)):
            x = self_layer(lp, x, cache["kv_t"], i)
    cache["pos"] = pos + 1
    return _head(params, x, cfg), cache
