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
:data:`CROSS_RANGE`. ``forward(remat=True)`` checkpoints each decoder
layer (``tp.checkpoint``, the reference's ``jax.checkpoint`` of the
decoder scan body); the encoder is not rematerialised.

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
engine and the trainer) the encoder and the decoder run on the rank's
shards, as the decoder-only transformer does: its query and K/V heads
(self and cross: the head counts are the projections' own), its column
blocks of the MLP and, where the vocabulary divides tp, its rows of
``tok_embed`` and columns of ``lm_head`` (``tp.vocab_embed`` /
``tp.vocab_logits``; a whole table passes through). Each encoder layer
ends in the two sums of ``attn_out`` and ``mlp_out``, each decoder layer
in three: self-attention, cross-attention and the MLP. The cross K/V
holds the rank's heads.

The dense cache follows the reference's ``cache_pspecs``
(``tp.cache_rows``), the decoder's ``kv`` and the cross ``xkv`` each on
its own: where Hkv does not divide tp and the positions do, a rank holds
every head over its slice of the positions, with ``"kv_slice"`` /
``"xkv_slice"``. ``prefill`` fills the slices, and ``decode_step``
attends over them context-parallel (``models/cp_attention.py``: the
self-attention by ``cp_decode_attention``, the cross-attention by
``cp_cross_attention``).

``forward`` trains on a ("data", "model") mesh (``train/step.py``):

* each column-parallel region starts with ``tp.region_in`` (f: the
  gradient summed over "model" backward): self-attention's QKV, the
  cross query, the MLP and, in every decoder layer, the cross K/V
  projection of ``enc_out`` (``"cross_in"``: each rank's gradient into
  ``enc_out`` is a partial, and without that sum every encoder
  parameter's gradient would be wrong);
* the stacks come through ``tp.layer_sources`` (FSDP gathers a layer
  when it is applied), ``tok_embed``, ``lm_head`` and the two final
  norms through ``tp.fsdp_full``;
* under sequence parallelism (``tp.seq_parallel`` of each stack's
  length) the encoder's residual stream is the rank's slice of the
  frames (``tp.seq_split`` before the positions, which are the rank's
  rows of the sinusoid), the decoder's the rank's slice of the tokens;
  the norms' scales are under ``tp.enter``; ``enc_out`` is gathered
  whole once a step for the cross K/V (``"enc_seq"``), its gradient
  reduce-scattered backward.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core import tp
from repro_torch.models import cp_attention, kvcache
from repro_torch.models.layers import (attention, attn_out, attn_qkv, mlp,
                                       paged_attention, rmsnorm)
from repro_torch.models.transformer import _fill, _head, unstack


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


def _positions(total: int, cfg, x, sp: bool):
    """The sinusoid's rows for ``x``: all ``total``, or under sequence
    parallelism (``sp``) the rows of the rank's slice of the positions."""
    pe = sinusoid(total, cfg.d_model, x.device)
    return (pe[tp.seq_rows(total)] if sp else pe).to(x.dtype)


def _scale(params, key: str, sp: bool):
    """A final norm's scale, whole over "data" (FSDP); under ``tp.enter``
    where it is used on the rank's sequence slice (``sp``)."""
    scale = tp.fsdp_full(params[key], key)
    return tp.enter(scale, "norm") if sp else scale


def _enc_block(lp, x, cfg, attn_impl: str, sp: bool):
    """One encoder layer: pre-norm non-causal attention and the GeLU MLP,
    on the rank's heads and blocks (``sp``: ``x`` the rank's slice of the
    frames, as ``transformer.block`` runs it)."""
    ln1, ln2 = lp["ln1"], lp["ln2"]
    if sp:
        ln1, ln2 = tp.enter(ln1, "norm"), tp.enter(ln2, "norm")
    h = tp.region_in(rmsnorm(x, ln1, cfg.norm_eps), "attn", seq=sp)
    q, k, v = attn_qkv(lp["attn"], h, cfg, rope=False)
    ctx = attention(q, tp.kv_read(k), tp.kv_read(v), causal=False,
                    impl=attn_impl)
    x = x + attn_out(lp["attn"], ctx, cfg, sp=sp)
    h = tp.region_in(rmsnorm(x, ln2, cfg.norm_eps), "mlp", seq=sp)
    return x + mlp(lp["mlp"], h, sp=sp)


def encode(params, frames, cfg, *, attn_impl: str = "auto",
           sp: bool = False):
    """frames: (B, enc_ctx, d_model) stub embeddings -> (B, enc_ctx, d).
    ``sp``: the frames split over "model" before the positions are added,
    and the rank's slice (B, enc_ctx / tp, d) returned."""
    x = frames.to(_dtype(cfg))
    total = x.shape[1]
    if sp:
        x = tp.seq_split(x, "frames")
    x = x + _positions(total, cfg, x, sp)
    for layer in tp.layer_sources(params["enc_layers"], cfg.encoder_layers,
                                  "enc_layers"):
        x = _enc_block(layer(), x, cfg, attn_impl, sp)
    return rmsnorm(x, _scale(params, "enc_norm", sp), cfg.norm_eps)


#: the ``record_function`` range the cross-attention's ops run under, so a
#: profile splits their device time out (a range costs a few microseconds
#: when no profiler runs)
CROSS_RANGE = "encdec_cross"


def cross_out(lp, x, kv, cfg, *, sp: bool = False, rows=None):
    """The pre-norm cross-attention's output (before the residual add)
    over precomputed K/V (B, T, Hkv, D), ``lp["lnx"]`` its norm: the
    rank's query heads (``sp``: of its slice of the tokens, the norm's
    scale under ``tp.enter``), summed by ``attn_out``; ``rows`` (a
    ``tp.SeqSlice``): the K/V are the rank's slice of the positions with
    every head, attended context-parallel. The VLM's cross layers use it
    too."""
    lnx = tp.enter(lp["lnx"], "norm") if sp else lp["lnx"]
    h = tp.region_in(rmsnorm(x, lnx, cfg.norm_eps), "xattn", seq=sp)
    b, s, _ = h.shape
    q = (h @ lp["xattn"]["wq"]).reshape(b, s, -1, cfg.head_dim)
    if rows is not None:
        ctx = cp_attention.cp_cross_attention(q, kv, rows=rows)
    else:
        ctx = attention(q, tp.kv_read(kv["k"]), tp.kv_read(kv["v"]),
                        causal=False, impl="full")
    return attn_out(lp["xattn"], ctx, cfg, sp=sp)


def _cross(lp, x, enc_kv, cfg, *, sp: bool = False, rows=None):
    """``x`` plus the cross-attention over the encoder K/V
    (``cross_out``)."""
    with record_function(CROSS_RANGE):
        return x + cross_out(lp, x, enc_kv, cfg, sp=sp, rows=rows)


def cross_kv(lp, enc_out, cfg):
    """One decoder layer's cross K/V of ``enc_out``, (B, T, Hkv, D) (a
    rank's K/V heads under a mesh). In training ``enc_out`` enters the
    rank's column-parallel K/V projection: its gradient is summed over
    "model" (``"cross_in"``), and so is that of ``wk`` / ``wv`` where
    they are whole on every rank (Hkv does not divide tp)."""
    b, t, _ = enc_out.shape
    wk, wv = lp["xattn"]["wk"], lp["xattn"]["wv"]
    if not tp.kv_split():
        wk, wv = tp.enter(wk, "kv_proj"), tp.enter(wv, "kv_proj")
    e = tp.region_in(enc_out, "cross")
    k = (e @ wk).reshape(b, t, -1, cfg.head_dim)
    v = (e @ wv).reshape(b, t, -1, cfg.head_dim)
    return {"k": k, "v": v}


def _lookup(params, tokens, cfg, *, sp: bool = False):
    table = tp.fsdp_full(params["tok_embed"], "tok_embed")
    return tp.vocab_embed(table, tokens, cfg.vocab_size, seq=sp).to(
        _dtype(cfg))


def _embed(params, tokens, cfg, *, sp: bool = False):
    x = _lookup(params, tokens, cfg, sp=sp)
    return x + _positions(tokens.shape[1], cfg, x, sp)


def _dec_block(lp, x, enc_out, cfg, attn_impl: str, sp: bool):
    """One decoder layer: causal self-attention, cross-attention over
    ``enc_out`` (whole: every encoder position), the GeLU MLP."""
    ln1, ln2 = lp["ln1"], lp["ln2"]
    if sp:
        ln1, ln2 = tp.enter(ln1, "norm"), tp.enter(ln2, "norm")
    h = tp.region_in(rmsnorm(x, ln1, cfg.norm_eps), "attn", seq=sp)
    q, k, v = attn_qkv(lp["attn"], h, cfg, rope=False)
    ctx = attention(q, tp.kv_read(k), tp.kv_read(v), causal=True,
                    impl=attn_impl)
    x = x + attn_out(lp["attn"], ctx, cfg, sp=sp)
    x = _cross(lp, x, cross_kv(lp, enc_out, cfg), cfg, sp=sp)
    h = tp.region_in(rmsnorm(x, ln2, cfg.norm_eps), "mlp", seq=sp)
    return x + mlp(lp["mlp"], h, sp=sp)


def forward(params, batch, cfg, *, remat: bool = False,
            attn_impl: str = "auto"):
    """batch: {"tokens": (B, S), "frames": (B, enc_ctx, d)} -> (decoder
    logits (B, S, V), aux 0). A batch without frames raises ``KeyError``
    here, as the reference's forward does (its token dataset yields
    tokens only). Under a rank each rank runs its shards (module
    docstring)."""
    if "frames" not in batch:
        raise KeyError(
            f"frames: {cfg.name} is an enc-dec model; its batches carry "
            "'frames' (B, encoder_ctx, d_model) beside 'tokens' (train it "
            "on a data= object whose batch(step) yields them)")
    frames, tokens = batch["frames"], batch["tokens"]
    sp_enc = tp.seq_parallel(frames.shape[1])
    sp = tp.seq_parallel(tokens.shape[1])
    enc_out = encode(params, frames, cfg, attn_impl=attn_impl, sp=sp_enc)
    if sp_enc:
        enc_out = tp.seq_gather(enc_out, "enc_seq")
    x = _embed(params, tokens, cfg, sp=sp)
    for layer in tp.layer_sources(params["dec_layers"], cfg.num_layers,
                                  "dec_layers"):
        def run(y, e, layer=layer):
            return _dec_block(layer(), y, e, cfg, attn_impl, sp)
        x = tp.checkpoint(run, x, enc_out) if remat else run(x, enc_out)
    return _head(params, x, cfg, sp=sp), \
        torch.zeros((), dtype=torch.float32, device=x.device)


def init_cache(cfg, batch: int, max_len: int, dtype=None, device=None):
    """Zero decoder K/V rows, zero cross K/V blocks and a scalar cursor.
    Under a live rank each is the rank's rows (``tp.cache_rows``, the
    reference's ``cache_pspecs``), with ``"kv_slice"`` / ``"xkv_slice"``
    where they are a slice of the positions."""
    dtype = dtype or cfg.dtype
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    out = {}
    for key, length in (("kv", max_len), ("xkv", cfg.encoder_ctx)):
        heads, sl = tp.cache_rows(cfg, length, ring=False, cp=False)
        rows = kvcache.init_kv(cfg.num_layers * batch,
                               length if sl is None else sl.length, heads,
                               cfg.head_dim, dtype, device)
        out[key] = {k: a.view(cfg.num_layers, batch, *a.shape[1:])
                    for k, a in rows.items()}
        if sl is not None:
            out[key + "_slice"] = sl
    out["pos"] = torch.zeros((), dtype=torch.int32, device=device)
    return out


def prefill(params, batch, cfg, cache, *, attn_impl: str = "auto"):
    """Encode the frames, fill each layer's cross K/V and the prompt's
    self-attention K/V (``kvcache.fit_prefill``) into ``cache`` in place
    (the rank's slice of each where the cache holds one), and return the
    last token's logits (B, 1, V)."""
    enc_out = encode(params, batch["frames"], cfg, attn_impl=attn_impl)
    tokens = batch["tokens"]
    kv, xkv = cache["kv"], cache["xkv"]
    sl, xsl = cache.get("kv_slice"), cache.get("xkv_slice")
    w = kv["k"].shape[2] if sl is None else sl.total
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
        _fill(kv, i, k, v, w, sl)
        _fill(xkv, i, ckv["k"], ckv["v"], cfg.encoder_ctx, xsl)
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
    through ``cache["ptab"]``. On the rank's slices of a dense cache
    (``"kv_slice"``, ``"xkv_slice"``) the attention is context-parallel.
    Returns (logits (B, 1, V), cache) with the K/V updated in place and
    ``"pos"`` advanced."""
    dev = token.device
    paged = "ptab" in cache
    pool = cache["kv"]
    sl, xsl = cache.get("kv_slice"), cache.get("xkv_slice")
    w = cache["ptab"].shape[1] * pool["k"].shape[2] if paged \
        else pool["k"].shape[2] if sl is None else sl.total
    pos = torch.as_tensor(pos, device=dev).to(torch.int32)
    batched = pos.ndim > 0
    at = torch.clamp(pos.long(), 0, w - 1).reshape(-1)
    # a gather by a tensor index (no host read of the cursor)
    pe = sinusoid(w, cfg.d_model, dev).index_select(0, at)[:, None]
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
        elif sl is not None:
            ctx = cp_attention.cp_decode_attention(q, kv, k, v, pos,
                                                   rows=sl)
        else:
            kvcache.write_kv(kv, k, v, pos)
            ctx = attention(q, tp.kv_read(kv["k"]), tp.kv_read(kv["v"]),
                            causal=True, q_offset=pos, kv_len=kv_len)
        x = x + attn_out(lp["attn"], ctx, cfg)
        with record_function(CROSS_RANGE):
            ckv = {n: a[i] if xslot is None else a[i][xslot]
                   for n, a in xkv.items()}
        x = _cross(lp, x, ckv, cfg, rows=xsl)
        x = x + mlp(lp["mlp"], rmsnorm(x, lp["ln2"], cfg.norm_eps))
    out = {"kv": pool, "xkv": xkv, "pos": pos + 1}
    for key in ("ptab", "kv_slice", "xkv_slice"):
        if key in cache:
            out[key] = cache[key]
    return _head(params, x, cfg), out
