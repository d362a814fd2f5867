"""Decoder-only transformer LM (llama-style, dense FFN) — the port of
``repro/models/transformer.py``.

Parameters are nested dicts of tensors with the JAX tree's keys and the
per-layer weights stacked on a leading L axis (``params.py``); the layer
stack is a Python loop over that axis where the reference scans.

  forward(params, batch, cfg)                  -> logits, aux
  decode_step(params, cache, token, pos, cfg)  -> logits, cache

``decode_step`` is the paged branch only — the serve engine's mixed
token-slot program: ``cache`` carries the pool ``"kv"`` (updated in
place), the page table ``"ptab"`` and optionally the write table
``"wtab"``. The dense, ring and context-parallel branches and ``prefill``
wait for later slices (ROADMAP.md Queue 1 item 4), as does the MoE FFN.
"""
from __future__ import annotations

import torch

from repro_torch.models import kvcache
from repro_torch.models.layers import (attention_full, attn_out, attn_qkv,
                                       mlp, paged_attention, rmsnorm)


def layer_params(params, i: int):
    """Layer ``i``'s weights: a view into the stacked L axis."""
    def pick(tree):
        return {k: pick(v) if isinstance(v, dict) else v[i]
                for k, v in tree.items()}
    return pick(params["layers"])


def _check_dense(cfg):
    if cfg.arch_type != "dense" or cfg.is_moe:
        raise NotImplementedError(
            f"{cfg.name}: the port runs dense decoders only so far; "
            f"{cfg.arch_type} waits for ROADMAP.md Queue 1 item 10")


def _embed(params, tokens, cfg):
    return params["embed"][tokens.long()].to(getattr(torch, cfg.dtype))


def _head(params, x, cfg):
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    w = params["lm_head"] if "lm_head" in params else params["embed"].T
    return x @ w


def block(lp, x, cfg):
    """Pre-norm attention + pre-norm SwiGLU FFN over a whole sequence."""
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = attn_qkv(lp["attn"], h, cfg)
    ctx = attention_full(q, k, v, causal=True, window=cfg.sliding_window)
    x = x + attn_out(lp["attn"], ctx, cfg)
    h = rmsnorm(x, lp["ln2"], cfg.norm_eps)
    return x + mlp(lp["mlp"], h)


def forward(params, batch, cfg):
    """batch: {"tokens": (B,S) int}. Returns (logits (B,S,V), aux=0)."""
    _check_dense(cfg)
    x = _embed(params, batch["tokens"], cfg)
    for i in range(cfg.num_layers):
        x = block(layer_params(params, i), x, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _head(params, x, cfg), aux


def decode_step(params, cache, token, pos, cfg):
    """token: (B,1) int; pos: (B,) int32 per-row cursors. Every row's K/V
    is scattered through ``cache.get("wtab", cache["ptab"])`` BEFORE any
    row attends through ``cache["ptab"]`` — which is what makes chunked
    prefill exact: a chunk's rows see each other's K/V. Returns
    (logits (B,1,V), cache) with ``cache["kv"]`` updated in place."""
    _check_dense(cfg)
    if "ptab" not in cache:
        raise NotImplementedError(
            "decode_step: only the paged layout is ported; the dense and "
            "ring caches wait for ROADMAP.md Queue 1 items 3-4")
    x = _embed(params, token, cfg)
    ptab = cache["ptab"]
    wtab = cache.get("wtab", ptab)
    pos = pos.to(torch.int32)
    positions = pos[:, None]
    pool = cache["kv"]
    for i in range(cfg.num_layers):
        lp = layer_params(params, i)
        h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = attn_qkv(lp["attn"], h, cfg, positions=positions)
        kv = {"k": pool["k"][i], "v": pool["v"][i]}
        kvcache.write_kv_paged(kv, k, v, wtab, pos)
        ctx = paged_attention(q, kv["k"], kv["v"], ptab, pos)
        x = x + attn_out(lp["attn"], ctx, cfg)
        h = rmsnorm(x, lp["ln2"], cfg.norm_eps)
        x = x + mlp(lp["mlp"], h)
    return _head(params, x, cfg), cache
