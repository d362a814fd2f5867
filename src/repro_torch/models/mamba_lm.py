"""Pure-SSM LM (mamba2-780m) — the port of ``repro/models/mamba_lm.py``:
attention-free, constant-size decode state.

Parameters are the nested dicts of ``params.py`` with the per-layer
weights stacked on a leading L axis; the layer stack is a Python loop
over that axis where the reference scans.

  forward(params, batch, cfg, remat=)            -> logits, aux
  init_cache(cfg, batch, max_len, dtype=, device=) -> cache
  prefill(params, batch, cfg, cache)             -> last logits, cache
  decode_step(params, cache, token, pos, cfg)    -> logits, cache

The cache is ``{"ssm": {"state": (L,B,H,P,N) fp32, "conv": (L,B,W-1,C)},
"pos": ...}``. ``prefill`` and ``decode_step`` write the new states into the
cache's tensors in place (the reference returns a new tree): the serve
engine holds one cache for its whole life, so no second copy of it is
made a step.

Under a tensor-parallel rank (``core/tp.py``, made current by the serving
engine or the trainer) every function runs on the rank's shards: the
vocab-parallel embedding and head of ``transformer._embed`` / ``_head``,
and in each layer the rank's ``H / tp`` heads of the Mamba2 block
(``models/ssm.py``); ``init_cache`` then gives the rank's (L, B, H/tp, P,
N) states and (L, B, W-1, din/tp + 2N) conv tails. ``forward`` trains on
a ("data", "model") mesh as ``transformer.forward`` does: FSDP's layers
gathered one at a time (``tp.layer_sources``, inside ``tp.checkpoint``
under remat) and, under sequence parallelism, the residual stream the
rank's slice of the sequence, gathered before ``in_proj`` and
reduce-scattered after ``out_proj`` while the conv and the scan run on the
whole sequence.
"""
from __future__ import annotations

import torch

from repro_torch.core import tp
from repro_torch.models import ssm
from repro_torch.models.layers import rmsnorm
from repro_torch.models.transformer import _embed, _head, unstack_layers


def mamba_layer(lp, x, cfg, *, sp: bool = False):
    """Pre-norm Mamba2 block with its residual (``sp``: ``x`` is the
    rank's sequence slice, the norm applied to it)."""
    norm = tp.enter(lp["norm"], "norm") if sp else lp["norm"]
    return x + ssm.mamba_forward(lp["mamba"],
                                 rmsnorm(x, norm, cfg.norm_eps), cfg, sp=sp)


def forward(params, batch, cfg, *, remat: bool = False, **_):
    """batch: {"tokens": (B,S) int}. Returns (logits (B,S,V), aux=0).
    ``remat=True`` wraps each layer in ``tp.checkpoint`` (the reference's
    ``jax.checkpoint`` of the scan body). Under a rank each rank runs its
    shards (module docstring)."""
    sp = tp.seq_parallel(batch["tokens"].shape[1])
    x = _embed(params, batch["tokens"], cfg, sp=sp)
    for layer in tp.layer_sources(params["layers"], cfg.num_layers,
                                  "layers"):
        def run(y, layer=layer):
            return mamba_layer(layer(), y, cfg, sp=sp)
        x = tp.checkpoint(run, x) if remat else run(x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _head(params, x, cfg, sp=sp), aux


def init_cache(cfg, batch: int, max_len: int, dtype=None, device=None):
    """Zero states for ``batch`` rows (``max_len`` is unused: the state
    does not grow with the context); under a live rank its heads'."""
    dtype = dtype or getattr(torch, cfg.dtype)
    one = ssm.init_mamba_cache(cfg, batch, dtype, device)
    return {"ssm": {k: torch.zeros((cfg.num_layers,) + tuple(v.shape),
                                   dtype=v.dtype, device=v.device)
                    for k, v in one.items()},
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def prefill(params, batch, cfg, cache=None, **_):
    """Run the prompt, return the last position's logits (B,1,V) and the
    cache, every layer's final state and conv tail written into it in
    place (the serve engine hands row views of its own); ``cache=None``
    makes one."""
    tokens = batch["tokens"]
    if cache is None:
        cache = init_cache(cfg, tokens.shape[0], tokens.shape[1],
                           device=tokens.device)
    x = _embed(params, tokens, cfg)
    for i, lp in enumerate(unstack_layers(params, cfg.num_layers)):
        y, st = ssm.mamba_forward(lp["mamba"],
                                  rmsnorm(x, lp["norm"], cfg.norm_eps), cfg,
                                  return_state=True)
        x = x + y
        for key in ("state", "conv"):
            cache["ssm"][key][i] = st[key]
    cache["pos"] = torch.tensor(tokens.shape[1], dtype=torch.int32,
                                device=x.device)
    return _head(params, x[:, -1:], cfg), cache


def decode_step(params, cache, token, pos, cfg):
    """token (B,1) int; ``pos`` scalar or per-row (B,): the recurrence is
    position-free, so only ``cache["pos"] = pos + 1`` changes. The states
    of ``cache["ssm"]`` are updated in place."""
    x = _embed(params, token, cfg)
    state, conv = cache["ssm"]["state"], cache["ssm"]["conv"]
    for i, lp in enumerate(unstack_layers(params, cfg.num_layers)):
        y, st = ssm.mamba_step(lp["mamba"],
                               {"state": state[i], "conv": conv[i]},
                               rmsnorm(x, lp["norm"], cfg.norm_eps), cfg)
        state[i] = st["state"]
        conv[i] = st["conv"]
        x = x + y
    cache["pos"] = pos + 1
    return _head(params, x, cfg), cache
