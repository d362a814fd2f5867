"""Whisper-style encoder-decoder (audio) — the port of
``repro/models/encdec.py``. The mel + conv frontend is stubbed as in the
reference: ``batch["frames"]`` carries precomputed ``(B, encoder_ctx,
d_model)`` frame embeddings. Sinusoidal positions, a bidirectional
encoder, a causal decoder with cross-attention, plain-GeLU MLPs and
RMSNorm everywhere (the reference's choice, not the paper's LayerNorm);
``lm_head`` is not tied to ``tok_embed``.

Parameters are nested dicts with the JAX tree's keys (``params.py``):
``enc_layers/`` and ``dec_layers/`` stacked on their own leading L axes;
the stacks are Python loops where the reference scans.

  encode(params, frames, cfg, attn_impl=)                   -> enc_out
  cross_kv(lp, enc_out, cfg)                                -> {"k", "v"}
  forward(params, batch, cfg, remat=, attn_impl=)           -> logits, aux
  init_cache(cfg, batch, max_len, dtype=, device=)          -> cache
  prefill(params, batch, cfg, cache, attn_impl=)            -> logits, cache
  decode_step(params, cache, token, pos, cfg)               -> logits, cache

The encoder's self-attention is non-causal and the decoder's causal, both
through ``layers.attention`` (on a CUDA tensor ``auto`` runs the flash
kernel); cross-attention is the reference's ``impl="full"``, plain
attention outside any kernel on either device, under the profiler range
:data:`CROSS_RANGE`. ``forward(remat=True)``
checkpoints each decoder layer (``torch.utils.checkpoint``, the
reference's ``jax.checkpoint`` of the decoder scan body); the encoder is
not rematerialised.

The cache is updated IN PLACE by ``prefill`` and ``decode_step``. Its
layouts: dense ``{"kv": (L, B, W, Hkv, D), "xkv": (L, B, encoder_ctx, Hkv,
D), "pos"}``; paged (the serve engine) ``{"kv": (L, n_pages, page_size,
Hkv, D) pool, "ptab"[, "wtab"], "xkv"}``, where the decoder's
self-attention K/V is scattered through ``wtab`` (default ``ptab``) and
read through ``ptab`` by the paged-attention kernel, and the cross K/V
stays a dense block a slot — its length is the fixed encoder context.
``decode_step`` also takes ``"xslot"``, a (B,) map from rows to the
leading axis of ``"xkv"``: each layer then gathers its own rows' cross
K/V (the engine's mixed step, whose rows are many tokens of few slots),
so one layer's gathered block is live at a time, not the whole stack.

Under a tensor-parallel mesh (``core/tp.py``, made current by the serving
engine) the encoder and the decoder run on the rank's shards, as the
decoder-only transformer does: its query and K/V heads (self and cross:
the head counts are the projections' own), its column blocks of the MLP
and, where the vocabulary divides tp, its rows of ``tok_embed`` and
columns of ``lm_head`` (``tp.vocab_embed`` / ``tp.vocab_logits``; a
whole table passes through). Each encoder layer ends in the two
all-reduces of ``attn_out`` and ``mlp``, each decoder layer in three:
self-attention, cross-attention and the MLP. The cross K/V holds the
rank's heads. ``forward`` (training) raises there, naming item 11's step
7 (the family on a mesh); the dense and MoE decoders train sharded.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from repro_torch.core import tp
from repro_torch.models import kvcache
from repro_torch.models.layers import (attention, attn_out, attn_qkv, mlp,
                                       paged_attention, rmsnorm)
from repro_torch.models.transformer import unstack


@functools.lru_cache(maxsize=None)
def _sinusoid_np(length: int, dim: int) -> np.ndarray:
    pos = np.arange(length)[:, None]
    i = np.arange(dim // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * i / dim)
    return np.concatenate([np.sin(ang), np.cos(ang)], -1).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _sinusoid_on(length: int, dim: int, device: str) -> torch.Tensor:
    return torch.from_numpy(_sinusoid_np(length, dim)).to(device)


def sinusoid(length: int, dim: int, device=None) -> torch.Tensor:
    """(length, dim) float32 positions: computed in float64 numpy and
    rounded once to float32, as the reference does (kept per device)."""
    return _sinusoid_on(length, dim, str(torch.device(device or "cpu")))


def _dtype(cfg):
    return getattr(torch, cfg.dtype)


def encode(params, frames, cfg, *, attn_impl: str = "auto"):
    """frames: (B, enc_ctx, d_model) stub embeddings -> (B, enc_ctx, d)."""
    x = frames.to(_dtype(cfg))
    x = x + sinusoid(x.shape[1], cfg.d_model, x.device).to(x.dtype)
    for lp in unstack(params["enc_layers"], cfg.encoder_layers):
        h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = attn_qkv(lp["attn"], h, cfg, rope=False)
        ctx = attention(q, tp.kv_read(k), tp.kv_read(v), causal=False,
                        impl=attn_impl)
        x = x + attn_out(lp["attn"], ctx, cfg)
        x = x + mlp(lp["mlp"], rmsnorm(x, lp["ln2"], cfg.norm_eps))
    return rmsnorm(x, params["enc_norm"], cfg.norm_eps)


#: the ``record_function`` range the cross-attention's ops run under, so a
#: profile splits their device time out (a range costs a few microseconds
#: when no profiler runs)
CROSS_RANGE = "encdec_cross"


def _cross(lp, x, enc_kv, cfg):
    """Cross-attention with precomputed encoder K/V (B, T, Hkv, D)."""
    with record_function(CROSS_RANGE):
        h = rmsnorm(x, lp["lnx"], cfg.norm_eps)
        b, s, _ = h.shape
        q = (h @ lp["xattn"]["wq"]).reshape(b, s, -1, cfg.head_dim)
        ctx = attention(q, tp.kv_read(enc_kv["k"]), tp.kv_read(enc_kv["v"]),
                        causal=False, impl="full")
        return x + attn_out(lp["xattn"], ctx, cfg)


def cross_kv(lp, enc_out, cfg):
    """One decoder layer's cross K/V of ``enc_out``, (B, T, Hkv, D) (a
    rank's K/V heads under a mesh)."""
    b, t, _ = enc_out.shape
    k = (enc_out @ lp["xattn"]["wk"]).reshape(b, t, -1, cfg.head_dim)
    v = (enc_out @ lp["xattn"]["wv"]).reshape(b, t, -1, cfg.head_dim)
    return {"k": k, "v": v}


def _lookup(params, tokens, cfg):
    return tp.vocab_embed(params["tok_embed"], tokens,
                          cfg.vocab_size).to(_dtype(cfg))


def _embed(params, tokens, cfg):
    x = _lookup(params, tokens, cfg)
    return x + sinusoid(x.shape[1], cfg.d_model, x.device).to(x.dtype)


def _head(params, x, cfg):
    return tp.vocab_logits(
        rmsnorm(x, params["final_norm"], cfg.norm_eps) @ params["lm_head"],
        cfg.vocab_size)


def _dec_block(lp, x, enc_out, cfg, attn_impl):
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = attn_qkv(lp["attn"], h, cfg, rope=False)
    ctx = attention(q, k, v, causal=True, impl=attn_impl)
    x = x + attn_out(lp["attn"], ctx, cfg)
    x = _cross(lp, x, cross_kv(lp, enc_out, cfg), cfg)
    return x + mlp(lp["mlp"], rmsnorm(x, lp["ln2"], cfg.norm_eps))


def forward(params, batch, cfg, *, remat: bool = False,
            attn_impl: str = "auto"):
    """batch: {"tokens": (B, S), "frames": (B, enc_ctx, d)} -> (decoder
    logits (B, S, V), aux 0). A batch without frames raises ``KeyError``
    here, as the reference's forward does (its token dataset yields
    tokens only)."""
    if "frames" not in batch:
        raise KeyError(
            f"frames: {cfg.name} is an enc-dec model; its batches carry "
            "'frames' (B, encoder_ctx, d_model) beside 'tokens' (train it "
            "on a data= object whose batch(step) yields them)")
    tp.check_training("encdec.forward", tp.FAMILY_STEP)
    enc_out = encode(params, batch["frames"], cfg, attn_impl=attn_impl)
    x = _embed(params, batch["tokens"], cfg)
    for lp in unstack(params["dec_layers"], cfg.num_layers):
        if remat:
            x = checkpoint(lambda y, e, lp=lp: _dec_block(lp, y, e, cfg,
                                                          attn_impl),
                           x, enc_out, use_reentrant=False)
        else:
            x = _dec_block(lp, x, enc_out, cfg, attn_impl)
    return _head(params, x, cfg), \
        torch.zeros((), dtype=torch.float32, device=x.device)


def init_cache(cfg, batch: int, max_len: int, dtype=None, device=None):
    """Zero decoder K/V rows, zero cross K/V blocks and a scalar cursor."""
    dtype = dtype or cfg.dtype
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    out = {}
    for key, length in (("kv", max_len), ("xkv", cfg.encoder_ctx)):
        rows = kvcache.init_kv(cfg.num_layers * batch, length,
                               cfg.num_kv_heads, cfg.head_dim, dtype, device)
        out[key] = {k: a.view(cfg.num_layers, batch, *a.shape[1:])
                    for k, a in rows.items()}
    out["pos"] = torch.zeros((), dtype=torch.int32, device=device)
    return out


def prefill(params, batch, cfg, cache, *, attn_impl: str = "auto"):
    """Encode the frames, fill each layer's cross K/V and the prompt's
    self-attention K/V (``kvcache.fit_prefill``) into ``cache`` in place,
    and return the last token's logits (B, 1, V)."""
    enc_out = encode(params, batch["frames"], cfg, attn_impl=attn_impl)
    tokens = batch["tokens"]
    kv, xkv = cache["kv"], cache["xkv"]
    w = kv["k"].shape[2]
    x = _embed(params, tokens, cfg)
    for i, lp in enumerate(unstack(params["dec_layers"], cfg.num_layers)):
        h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = attn_qkv(lp["attn"], h, cfg, rope=False)
        ctx = attention(q, tp.kv_read(k), tp.kv_read(v), causal=True,
                        impl=attn_impl)
        x = x + attn_out(lp["attn"], ctx, cfg)
        ckv = cross_kv(lp, enc_out, cfg)
        x = _cross(lp, x, ckv, cfg)
        x = x + mlp(lp["mlp"], rmsnorm(x, lp["ln2"], cfg.norm_eps))
        kv["k"][i] = kvcache.fit_prefill(k, w)
        kv["v"][i] = kvcache.fit_prefill(v, w)
        xkv["k"][i] = ckv["k"]
        xkv["v"][i] = ckv["v"]
    cache["pos"] = torch.tensor(tokens.shape[1], dtype=torch.int32,
                                device=x.device)
    return _head(params, x[:, -1:], cfg), cache


def decode_step(params, cache, token, pos, cfg):
    """token: (B, 1) int; pos: scalar (the lockstep loop) or (B,) per-row
    cursors (the engine's slot table). Positions index the sinusoid table
    of the cache's width (``ptab`` width x page size on the paged layout)
    clamped to its ends, as the reference's gather does. A cache with a
    ``"ptab"`` takes the paged branch: every row's K/V is scattered
    through ``cache.get("wtab", cache["ptab"])`` before any row attends
    through ``cache["ptab"]``. Returns (logits (B, 1, V), cache) with the
    K/V updated in place and ``"pos"`` advanced."""
    dev = token.device
    paged = "ptab" in cache
    pool = cache["kv"]
    w = cache["ptab"].shape[1] * pool["k"].shape[2] if paged \
        else pool["k"].shape[2]
    pos = torch.as_tensor(pos, device=dev).to(torch.int32)
    batched = pos.ndim > 0
    at = torch.clamp(pos.long(), 0, w - 1)
    pe = sinusoid(w, cfg.d_model, dev)[at]
    pe = pe[:, None] if batched else pe[None, None]
    x = _lookup(params, token, cfg) + pe.to(_dtype(cfg))
    rows = pos if batched else pos.expand(token.shape[0]).contiguous()
    if paged:
        ptab = cache["ptab"]
        wtab = cache.get("wtab", ptab)
    else:
        kv_len = torch.clamp(pos + 1, max=w)
    xkv, xslot = cache["xkv"], cache.get("xslot")
    for i, lp in enumerate(unstack(params["dec_layers"], cfg.num_layers)):
        h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = attn_qkv(lp["attn"], h, cfg, rope=False)
        kv = {"k": pool["k"][i], "v": pool["v"][i]}
        if paged:
            kvcache.write_kv_paged(kv, k, v, wtab, rows)
            ctx = paged_attention(q, tp.kv_read(kv["k"]),
                                  tp.kv_read(kv["v"]), ptab, rows)
        else:
            kvcache.write_kv(kv, k, v, pos)
            ctx = attention(q, tp.kv_read(kv["k"]), tp.kv_read(kv["v"]),
                            causal=True, q_offset=pos, kv_len=kv_len)
        x = x + attn_out(lp["attn"], ctx, cfg)
        with record_function(CROSS_RANGE):
            ckv = {n: a[i] if xslot is None else a[i][xslot]
                   for n, a in xkv.items()}
        x = _cross(lp, x, ckv, cfg)
        x = x + mlp(lp["mlp"], rmsnorm(x, lp["ln2"], cfg.norm_eps))
    out = {"kv": pool, "xkv": xkv, "pos": pos + 1}
    if paged:
        out["ptab"] = cache["ptab"]
    return _head(params, x, cfg), out
