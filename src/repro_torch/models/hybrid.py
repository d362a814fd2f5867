"""Zamba2-style hybrid (zamba2-1.2b) — the port of
``repro/models/hybrid.py``: a Mamba2 backbone and ONE shared attention +
SwiGLU block applied after every ``hybrid_attn_every`` Mamba layers
[arXiv:2411.15242].

    G = num_layers // hybrid_attn_every groups of
        [every x (norm -> mamba)] -> shared (norm -> attn -> norm -> mlp)
    + (num_layers % every) trailing Mamba layers.

The shared block's WEIGHTS serve every application; each application
keeps its own KV cache. Parameters are the nested dicts of ``params.py``:
``groups/*`` stacked ``(G, every, ...)``, ``trailing/*`` ``(max(rest, 1),
...)`` (one unused layer when ``rest == 0``, as the reference keeps),
``shared/*`` unstacked. The stacks are Python loops where the reference
scans.

  forward(params, batch, cfg, remat=, attn_impl=)   -> logits, aux
  init_cache(cfg, batch, max_len, dtype=, device=)  -> cache
  prefill(params, batch, cfg, cache=None)           -> last logits, cache
  decode_step(params, cache, token, pos, cfg)       -> logits, cache

The cache is ``{"ssm_g": {"state": (G*every, B, H, P, N) fp32, "conv":
(G*every, B, W-1, C)}, "ssm_t": the same over max(rest, 1) layers, "kv":
{"k", "v": (G, B, w, Hkv, D)}, "pos"}`` with ``w =
transformer.cache_window(cfg, max_len)`` (the ring of the window on
sliding-window configs). ``prefill`` and ``decode_step`` write it IN
PLACE, as ``mamba_lm`` and ``transformer`` do: the serve engine holds one
cache for its whole life and hands ``prefill`` row views of it.

On a CUDA tensor a prefill runs the SSD kernel in every Mamba layer, the
flash kernel in every application of the shared block's attention and the
fused MLP kernel in every application of its MLP; a decode step runs the
fused MLP once a group (``layers.py``, ``ssm.py``).

Under a tensor-parallel rank (``core/tp.py``) every function runs on the
rank's shards: the Mamba layers on their ``H / tp`` heads
(``models/ssm.py``), the shared block on the dense decoder's tp path (the
rank's query heads, its K/V heads or the one its query heads read,
``d_ff / tp`` of the MLP: ``layers.attn_qkv`` / ``attn_out`` / ``mlp``,
``tp.kv_read``), the vocab-parallel embedding and head. ``init_cache``
gives the rank's states and K/V rows by ``tp.cache_rows`` (the rank's
sequence slice of every row, with ``"kv_slice"``, where Hkv does not
divide tp: ``prefill`` fills the slice and ``decode_step`` takes
``models/cp_attention.py``'s branch, as the dense decoder does).
``forward`` trains on a ("data", "model") mesh as ``transformer.forward``
does: FSDP's groups, trailing layers and shared block gathered when
applied (inside ``tp.checkpoint`` under remat), and under sequence
parallelism the residual stream the rank's slice of the sequence.
"""
from __future__ import annotations

import torch

from repro_torch.core import tp
from repro_torch.models import cp_attention, kvcache, ssm
from repro_torch.models.layers import (attention, attn_out, attn_qkv, mlp,
                                       rmsnorm)
from repro_torch.models.mamba_lm import mamba_layer
from repro_torch.models.transformer import (_embed, _fill, _head, _is_ring,
                                            block, cache_window, unstack)
from repro_torch.tree import flatten, unflatten


def _shared(params):
    """The shared block's leaves, each whole over "data" where FSDP
    splits it (gathered at each application)."""
    return unflatten({k: tp.fsdp_full(v, f"shared/{k}")
                      for k, v in flatten(params["shared"]).items()})


def _group(glp, params, x, cfg, attn_impl, sp):
    """``every`` Mamba layers, then the shared block."""
    for lp in unstack(glp, cfg.hybrid_attn_every):
        x = mamba_layer(lp, x, cfg, sp=sp)
    return block(_shared(params), x, cfg, attn_impl=attn_impl, sp=sp)[0]


def forward(params, batch, cfg, *, remat: bool = False,
            attn_impl: str = "auto"):
    """batch: {"tokens": (B,S) int}. Returns (logits (B,S,V), aux=0).
    ``remat=True`` wraps each group (its Mamba layers and the shared
    block) in ``tp.checkpoint``, as the reference checkpoints its group
    scan body; the trailing layers are not rematerialized. Under a rank
    each rank runs its shards (module docstring)."""
    sp = tp.seq_parallel(batch["tokens"].shape[1])
    x = _embed(params, batch["tokens"], cfg, sp=sp)
    g, rest = cfg.hybrid_groups
    for group in tp.layer_sources(params["groups"], g, "groups"):
        def run(y, group=group):
            return _group(group(), params, y, cfg, attn_impl, sp)
        x = tp.checkpoint(run, x) if remat else run(x)
    if rest:
        for layer in tp.layer_sources(params["trailing"], rest,
                                      "trailing"):
            x = mamba_layer(layer(), x, cfg, sp=sp)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _head(params, x, cfg, sp=sp), aux


def init_cache(cfg, batch: int, max_len: int, dtype=None, device=None):
    """Zero SSM states (fp32) and conv tails for every Mamba layer and zero
    K/V of ``cache_window(cfg, max_len)`` rows for every application of
    the shared block; under a live rank the rank's heads and rows
    (``tp.cache_rows``, with ``"kv_slice"`` where they are a slice)."""
    dtype = dtype or cfg.dtype
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    g, rest = cfg.hybrid_groups
    one = ssm.init_mamba_cache(cfg, batch, dtype, device)

    def stack(n):
        return {k: torch.zeros((n,) + tuple(v.shape), dtype=v.dtype,
                               device=v.device) for k, v in one.items()}

    w = cache_window(cfg, max_len)
    heads, sl = tp.cache_rows(cfg, w, ring=_is_ring(cfg, w), cp=False)
    # every group's rows in one allocation, the leading G axis a view
    rows = kvcache.init_kv(g * batch, w if sl is None else sl.length,
                           heads, cfg.head_dim, dtype, device)
    cache = {"ssm_g": stack(g * cfg.hybrid_attn_every),
             "ssm_t": stack(max(rest, 1)),
             "kv": {k: a.view(g, batch, *a.shape[1:])
                    for k, a in rows.items()},
             "pos": torch.zeros((), dtype=torch.int32, device=device)}
    if sl is not None:
        cache["kv_slice"] = sl
    return cache


def _mamba_prefill(lp, x, cfg, states, i):
    """One Mamba layer over the prompt; its final state and conv tail go
    to layer ``i`` of ``states``."""
    y, st = ssm.mamba_forward(lp["mamba"],
                              rmsnorm(x, lp["norm"], cfg.norm_eps), cfg,
                              return_state=True)
    states["state"][i] = st["state"]
    states["conv"][i] = st["conv"]
    return x + y


def prefill(params, batch, cfg, cache=None, *, attn_impl: str = "auto",
            **_):
    """Run the prompt at its exact length (the recurrence is
    pad-sensitive) and return the last token's logits (B, 1, V) and the
    cache, filled in place: every Mamba layer's final state and conv tail,
    every application's K/V through ``kvcache.fit_prefill``, and
    ``ssm_t`` zeroed when there are no trailing layers. ``cache=None``
    makes one of the prompt's length."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    if cache is None:
        cache = init_cache(cfg, b, s, device=tokens.device)
    kv = cache["kv"]
    sl = cache.get("kv_slice")
    w = kv["k"].shape[2] if sl is None else sl.total
    g, rest = cfg.hybrid_groups
    e = cfg.hybrid_attn_every
    sp = params["shared"]
    x = _embed(params, tokens, cfg)
    for gi, glp in enumerate(unstack(params["groups"], g)):
        for j, lp in enumerate(unstack(glp, e)):
            x = _mamba_prefill(lp, x, cfg, cache["ssm_g"], gi * e + j)
        h = rmsnorm(x, sp["ln1"], cfg.norm_eps)
        q, k, v = attn_qkv(sp["attn"], h, cfg)
        ctx = attention(q, tp.kv_read(k), tp.kv_read(v), causal=True,
                        window=cfg.sliding_window, impl=attn_impl)
        x = x + attn_out(sp["attn"], ctx, cfg)
        x = x + mlp(sp["mlp"], rmsnorm(x, sp["ln2"], cfg.norm_eps))
        _fill(kv, gi, k, v, w, sl)
    if rest:
        for i, lp in enumerate(unstack(params["trailing"], rest)):
            x = _mamba_prefill(lp, x, cfg, cache["ssm_t"], i)
    else:
        for leaf in cache["ssm_t"].values():
            leaf.zero_()
    cache["pos"] = torch.tensor(s, dtype=torch.int32, device=x.device)
    return _head(params, x[:, -1:], cfg), cache


def _mamba_decode(lp, x, cfg, states, i):
    """One Mamba layer's recurrent step on layer ``i`` of ``states``, in
    place."""
    y, st = ssm.mamba_step(lp["mamba"],
                           {"state": states["state"][i],
                            "conv": states["conv"][i]},
                           rmsnorm(x, lp["norm"], cfg.norm_eps), cfg)
    states["state"][i] = st["state"]
    states["conv"][i] = st["conv"]
    return x + y


def decode_step(params, cache, token, pos, cfg):
    """token: (B,1) int; ``pos``: scalar (the lockstep loop) or (B,)
    per-row cursors (the engine's slot table). Each application of the
    shared block writes its K/V at the row's cursor (``pos % w`` on the
    ring) and attends to its valid prefix, ``kv_len = min(pos + 1, w)``,
    or through ``kvcache.ring_kpos`` on the ring. The states and K/V of
    ``cache`` are updated in place; returns (logits (B,1,V), cache) with
    ``"pos"`` advanced."""
    x = _embed(params, token, cfg)
    g, rest = cfg.hybrid_groups
    e = cfg.hybrid_attn_every
    sp = params["shared"]
    kv = cache["kv"]
    sl = cache.get("kv_slice")
    w = kv["k"].shape[2] if sl is None else sl.total
    ring = _is_ring(cfg, w)
    pos = torch.as_tensor(pos, device=x.device).to(torch.int32)
    positions = pos[:, None] if pos.ndim else pos.expand(token.shape[0], 1)
    kpos = kvcache.ring_kpos(positions, w) if ring else None
    kv_len = None if ring else torch.clamp(pos + 1, max=w)
    for gi, glp in enumerate(unstack(params["groups"], g)):
        for j, lp in enumerate(unstack(glp, e)):
            x = _mamba_decode(lp, x, cfg, cache["ssm_g"], gi * e + j)
        h = rmsnorm(x, sp["ln1"], cfg.norm_eps)
        q, k, v = attn_qkv(sp["attn"], h, cfg, positions=positions)
        kvg = {"k": kv["k"][gi], "v": kv["v"][gi]}
        if sl is not None:
            ctx = cp_attention.cp_decode_attention(
                q, kvg, k, v, pos, window=cfg.sliding_window, rows=sl,
                ring=ring)
        else:
            kvcache.write_kv(kvg, k, v, pos, ring=ring, window=w)
            ctx = attention(q, tp.kv_read(kvg["k"]), tp.kv_read(kvg["v"]),
                            causal=True, window=cfg.sliding_window,
                            q_offset=pos, kv_len=kv_len, kpos=kpos)
        x = x + attn_out(sp["attn"], ctx, cfg)
        x = x + mlp(sp["mlp"], rmsnorm(x, sp["ln2"], cfg.norm_eps))
    if rest:
        for i, lp in enumerate(unstack(params["trailing"], rest)):
            x = _mamba_decode(lp, x, cfg, cache["ssm_t"], i)
    cache["pos"] = pos + 1
    return _head(params, x, cfg), cache
