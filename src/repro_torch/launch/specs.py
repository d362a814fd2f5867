"""Meta-device stand-ins for every input of a rank's step, with each one's
spec — the no-allocation inputs the dry-run traces (the port of
``repro/launch/specs.py``).

Where the reference gives ``ShapeDtypeStruct``s of the GLOBAL arrays and
the ``NamedSharding`` that lays each out, the port gives the tensors one
RANK holds, on ``torch.device("meta")`` (nothing drawn, nothing
allocated), and the :class:`~repro_torch.core.pspec.P` each is cut by:

* the parameters: the rank's block of each leaf (``core/tp.py::
  leaf_specs`` / ``local_shape``, the tables a real rank uses);
* the optimizer state: ``train/step.py::init_opt_state`` on those blocks
  under the rank (ZeRO-1 over "data" and FSDP blocks as a trainer holds
  them);
* the batch: ``tokens`` (B, S) int32, with ``frames`` (B, encoder ctx,
  d) fp32 for the enc-dec family and ``image_embeds`` (B, image tokens,
  d) fp32 for the VLM, by rows over the data-parallel axis ("pod" x
  "data") where they divide (``batch_shardings``);
* for decode, the dense cache (``init_cache`` under the rank:
  ``core/tp.py::cache_rows``), a (B, 1) token and a 0-d int32 position.

Without a rank (one chip) every spec is replicated and every tensor
whole. Call these under the rank the step will run on (``tp.active``).
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils._pytree import tree_flatten

from repro_torch.core import tp
from repro_torch.core.pspec import P
from repro_torch.core.strategy import Strategy, mesh_axes
from repro_torch.models import get_model
from repro_torch.optim.optimizers import _state_specs
from repro_torch.params import param_spec
from repro_torch.train.step import init_opt_state
from repro_torch.tree import flatten, unflatten

META = torch.device("meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def data_parallel(mesh) -> int:
    """Ranks of the data-parallel axis ("pod" x "data") of ``mesh``."""
    axes = mesh_axes(mesh) if mesh is not None else {}
    return axes.get("pod", 1) * axes.get("data", 1)


def batch_specs(cfg, batch: int, seq: int) -> Dict[str, Any]:
    """The batch of ``batch`` rows of ``seq`` tokens, on meta."""
    out = {"tokens": _meta((batch, seq), torch.int32)}
    if cfg.has_encoder:
        out["frames"] = _meta((batch, cfg.encoder_ctx, cfg.d_model),
                              torch.float32)
    if cfg.cross_attn_every > 0:
        out["image_embeds"] = _meta((batch, cfg.num_image_tokens,
                                     cfg.d_model), torch.float32)
    return out


def batch_shardings(cfg, batch: int, mesh, strategy: Strategy):
    """Each batch key's spec: rows over the rules' batch axes where the
    rows divide the data-parallel ranks, else whole."""
    rules = strategy.rules(mesh if mesh is not None else {})
    bspec = rules["batch"] if batch % data_parallel(mesh) == 0 else None
    out = {"tokens": P(bspec, None)}
    if cfg.has_encoder:
        out["frames"] = P(bspec, None, None)
    if cfg.cross_attn_every > 0:
        out["image_embeds"] = P(bspec, None, None)
    return out


def rank_rows(batch: int, mesh) -> int:
    """Rows of a ``batch``-row global batch one rank holds."""
    dp = data_parallel(mesh)
    return batch // dp if batch % dp == 0 else batch


def abstract_params(cfg, strategy: Strategy, mesh):
    """(the rank's parameter blocks on meta, their specs)."""
    spec = param_spec(cfg)
    if mesh is None:
        return (unflatten({k: _meta(s, d) for k, (s, d, _) in spec.items()}),
                unflatten({k: P(*([None] * len(s)))
                           for k, (s, _, _) in spec.items()}))
    shapes = {k: s for k, (s, _, _) in spec.items()}
    specs = tp.leaf_specs(shapes, strategy, mesh, cfg)
    axes = mesh_axes(mesh)
    return (unflatten({k: _meta(tp.local_shape(s, specs[k], axes), d)
                       for k, (s, d, _) in spec.items()}),
            unflatten(specs))


def opt_state_specs(opt_state, rank) -> dict:
    """The spec of each optimizer-state leaf: AdamW's ``m`` / ``v`` /
    ``master`` the leaf's update block (``LeafBlocks.update``), Adafactor's
    ``vr`` / ``vc`` their factored specs, ``step`` replicated."""
    out = {}
    for name, sub in opt_state.items():
        if not isinstance(sub, dict):
            out[name] = P()
            continue
        flat = {}
        for key, leaf in flatten(sub).items():
            if rank is None or not rank.leaves:
                flat[key] = P(*([None] * leaf.ndim))
                continue
            lb = rank.leaves[key]
            if name in ("vr", "vc"):
                rs, cs = _state_specs(lb, rank)
                flat[key] = rs if name == "vr" else cs
            else:
                flat[key] = lb.update
        out[name] = unflatten(flat)
    return out


def train_specs(cfg, shape, mesh, strategy: Strategy):
    """((params, opt_state, batch), (param specs, opt specs, batch
    specs)) for ``train_step(params, opt_state, batch)``. The port's step
    takes the global batch on every rank and keeps its rows
    (``data/pipeline.py::shard_batch``), so ``batch`` is global; its spec
    says which rows the rank keeps."""
    params, psh = abstract_params(cfg, strategy, mesh)
    opt = init_opt_state(params, strategy)
    batch = batch_specs(cfg, shape.global_batch, shape.seq_len)
    return (params, opt, batch), (psh, opt_state_specs(opt, tp.current()),
                                  batch_shardings(cfg, shape.global_batch,
                                                  mesh, strategy))


def prefill_specs(cfg, shape, mesh, strategy: Strategy):
    """((params, batch), (param specs, batch specs)): the rank's rows of
    the batch (an engine on a replica prefills its own requests)."""
    params, psh = abstract_params(cfg, strategy, mesh)
    batch = batch_specs(cfg, rank_rows(shape.global_batch, mesh),
                        shape.seq_len)
    return (params, batch), (psh, batch_shardings(cfg, shape.global_batch,
                                                  mesh, strategy))


def decode_specs(cfg, shape, mesh, strategy: Strategy):
    """((params, cache, token, pos), their specs): ONE new token of the
    rank's rows against a cache of ``seq_len`` positions."""
    params, psh = abstract_params(cfg, strategy, mesh)
    rows = rank_rows(shape.global_batch, mesh)
    cache = get_model(cfg).init_cache(cfg, rows, shape.seq_len, device=META)
    token = _meta((rows, 1), torch.int32)
    pos = _meta((), torch.int32)
    bsh = batch_shardings(cfg, shape.global_batch, mesh, strategy)["tokens"]
    return (params, cache, token, pos), \
        (psh, cache_specs(cfg, shape, strategy, mesh), bsh, P())


def cache_specs(cfg, shape, strategy: Strategy, mesh):
    """The reference's ``cache_pspecs`` (``core/sharding.py``) of the
    global cache; a rank's tensors are the blocks ``init_cache`` gives it
    under the rank (``core/tp.py::cache_rows``: its heads, or a sequence
    slice where Hkv does not divide)."""
    from repro_torch.core.sharding import cache_pspecs
    with tp.active(None):
        whole = get_model(cfg).init_cache(cfg, shape.global_batch,
                                          shape.seq_len, device=META)
    leaves = {k: v for k, v in flatten(whole).items()
              if isinstance(v, torch.Tensor)}
    if mesh is None:
        return unflatten({k: P(*([None] * v.ndim))
                          for k, v in leaves.items()})
    return cache_pspecs(unflatten(leaves), strategy, mesh, shape.global_batch)


def tensor_bytes(*trees) -> int:
    """Bytes of the distinct storages of the tensors in ``trees``."""
    seen, total = set(), 0
    for leaf in tree_flatten(trees)[0]:
        if not isinstance(leaf, torch.Tensor):
            continue
        st = leaf.untyped_storage()
        if id(st) in seen:
            continue
        seen.add(id(st))
        total += st.nbytes()
    return total
