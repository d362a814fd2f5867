"""Tensor parallelism on explicit local shards — one process a rank.

The reference runs one GSPMD program over the mesh: every parameter is a
global array laid out by ``core/sharding.py``'s specs, and XLA inserts
the collectives. The port follows PyTorch's idiom instead (``torchrun``,
one process a rank): each rank holds only its shard of every leaf, as a
plain contiguous local tensor (``shard_params``), runs the same model
code on it, and calls the collective where GSPMD would have put one
(Megatron §5.1):

* ``all_reduce(x, "attn_out")`` after ``wo`` (row-parallel attention
  out) and ``all_reduce(x, "mlp_out")`` after ``w_down`` (row-parallel
  MLP), one each a layer;
* ``vocab_embed``: the vocab-parallel lookup, a masked local lookup and
  one sum;
* ``vocab_logits``: the vocab-parallel head's logits assembled to the full
  vocabulary by one sum into a zero-filled buffer where each rank writes
  its slice (exact: only zeros are added);
* ``broadcast_from_root`` for what one rank decides for all (the serving
  engine's sampled tokens and clock);
* ``all_reduce(x, what, op=MAX)`` and the zero-filled sums of
  ``gather_heads`` for the context-parallel decode
  (``models/cp_attention.py``).

Only ``all_reduce`` and ``broadcast`` are used: gloo supports just these
two on CUDA tensors, so the same code runs with gloo on CPU tensors (the
tests), with gloo on CUDA tensors (ranks sharing one card: NCCL refuses
two ranks on one device) and with NCCL (one card a rank). The backend is
the process group's, chosen by the caller; nothing here switches it.

A rank's view (:class:`Rank`) is made from the mesh and the model config
by the caller (the serving engine) and made current for a thread by
``active``; without a current rank, or at tp 1, every collective here is
a no-op and the model code runs unsharded. Attention is split by whole
heads only: Hq must divide by tp. Where Hkv does not divide by tp (GQA
with fewer KV heads than ranks), every rank keeps all Hkv heads of K/V
(the table's replicated fallback) and attends its query heads against
the one KV head they read (``kv_read``); the table itself would split
``wk``/``wv`` inside a head there (``_divisible`` tests the flattened
``Hkv * D``), which the port never does (``rank_pspecs``).

A dense K/V cache follows the reference's ``cache_pspecs``
(``cache_rows``): the rank's K/V heads where Hkv divides tp, otherwise
the rank's SEQUENCE slice of every row with all Hkv heads where the
cache's positions divide tp (replicated where neither does); under
``cfg.cp_decode`` a lockstep cache that is no ring is sequence-sharded
whatever the heads, as the reference's ``shard_map`` reshards it. A
sliced cache carries its :class:`SeqSlice` under ``"kv_slice"``, and
``decode_step`` then takes the context-parallel branch.
"""
from __future__ import annotations

import math
import threading
from collections import Counter
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.core.pspec import P
from repro_torch.core.sharding import (param_logical, param_pspecs,
                                      tree_map_with_path)
from repro_torch.core.strategy import mesh_axes
from repro_torch.tree import flatten, unflatten

_state = threading.local()


@dataclass
class Rank:
    """One rank's place on the "model" axis and what it holds of the
    model: ``heads`` query heads, ``kv_heads`` K/V heads in its cache
    (Hkv / tp, or all Hkv where they do not divide), of which its query
    heads read ``kv_read`` (a slice of the cache's head axis; None: all
    of them). ``counts`` tallies the collectives issued, by what they
    carry, and ``bytes`` the bytes each put in (``numel *
    element_size`` of the tensor reduced or broadcast)."""
    tp: int
    rank: int
    group: object
    root: int
    heads: int
    kv_heads: int
    kv_read: Optional[slice]
    counts: Counter = field(default_factory=Counter)
    bytes: Counter = field(default_factory=Counter)

    @classmethod
    def of(cls, mesh, cfg) -> "Rank":
        """The calling process's view of ``mesh``'s "model" axis for
        ``cfg``'s attention. Raises ``ValueError`` for shapes that cannot
        be split by whole heads."""
        tp = mesh_axes(mesh).get("model", 1)
        sub = mesh["model"]
        group = mesh.get_group("model")
        hq, hkv = cfg.num_heads, cfg.num_kv_heads
        if hq % tp:
            raise ValueError(
                f"{cfg.name}: {hq} query heads do not split over tp={tp} "
                "(attention is split by whole heads)")
        if hkv % tp and tp % hkv:
            raise ValueError(
                f"{cfg.name}: {hkv} KV heads over tp={tp}: neither divides "
                "the other, so a rank's query heads would read parts of "
                "two KV heads")
        if cfg.d_ff % tp:
            raise ValueError(f"{cfg.name}: d_ff {cfg.d_ff} does not split "
                             f"over tp={tp}")
        r = int(sub.get_local_rank())
        if hkv % tp == 0:
            kv_heads, kv_read = hkv // tp, None
        else:
            i = r // (tp // hkv)
            kv_heads, kv_read = hkv, slice(i, i + 1)
        return cls(tp=tp, rank=r, group=group,
                   root=dist.get_global_rank(group, 0),
                   heads=hq // tp, kv_heads=kv_heads, kv_read=kv_read)

    @property
    def kv_sharded(self) -> bool:
        return self.kv_read is None

    def tally(self, what: str, x: torch.Tensor):
        self.counts[what] += 1
        self.bytes[what] += x.numel() * x.element_size()


@dataclass(frozen=True)
class SeqSlice:
    """A rank's rows of a dense K/V cache of ``total`` positions
    sequence-sharded over "model": positions ``[start, start +
    length)`` (ring slots on a ring), with every K/V head."""
    start: int
    length: int
    total: int


def cache_rows(cfg, length: int, *, ring: bool, cp: bool):
    """(K/V heads, :class:`SeqSlice` or None) the current rank holds of
    a dense K/V cache of ``length`` positions, by the reference's
    ``cache_pspecs`` (core/sharding.py:231-240): the sequence slice with
    all Hkv heads where ``length`` divides tp and either Hkv does not, or
    ``cp`` asks for it on a cache that is no ring (the context-parallel
    decode's reshard); else Hkv / tp heads where they divide, all of them
    otherwise. Without a live rank: all heads, whole rows."""
    r = _live()
    hkv = cfg.num_kv_heads
    if r is None:
        return hkv, None
    if length % r.tp == 0 and (hkv % r.tp or (cp and not ring)):
        n = length // r.tp
        return hkv, SeqSlice(r.rank * n, n, length)
    return r.kv_heads, None


def current() -> Optional[Rank]:
    """The rank made current for this thread by ``active``, or None."""
    return getattr(_state, "rank", None)


@contextmanager
def active(rank: Optional[Rank]):
    """Make ``rank`` (None: no sharding) current for this thread."""
    old = current()
    _state.rank = rank
    try:
        yield rank
    finally:
        _state.rank = old


def _live() -> Optional[Rank]:
    r = current()
    return r if r is not None and r.tp > 1 else None


def all_reduce(x: torch.Tensor, what: str,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Sum (or ``op``: MAX) ``x`` over the current rank's group, in
    place (``x`` must be contiguous); a no-op without one or at tp 1."""
    r = _live()
    if r is None:
        return x
    r.tally(what, x)
    dist.all_reduce(x, op=op, group=r.group)
    return x


def broadcast_from_root(x: torch.Tensor, what: str) -> torch.Tensor:
    """Rank 0's ``x`` on every rank of the current group, in place."""
    r = _live()
    if r is None:
        return x
    r.tally(what, x)
    dist.broadcast(x, src=r.root, group=r.group)
    return x


def same_on_all(value: int, what: str, device) -> bool:
    """Whether every rank of the current group passed the same ``value``
    (a 63-bit int): one all-reduce with MAX of ``(value, -value)`` gives
    the largest and the smallest."""
    r = _live()
    if r is None:
        return True
    t = torch.tensor([value, -value], dtype=torch.int64, device=device)
    r.tally(what, t)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=r.group)
    return int(t[0]) == -int(t[1])


def vocab_embed(table: torch.Tensor, tokens: torch.Tensor,
                vocab_size: int) -> torch.Tensor:
    """``table[tokens]`` for a vocab-parallel ``table`` (this rank's
    ``V / tp`` rows): rows of tokens outside the rank's range are zero,
    and one sum gives every rank the full lookup. A whole table is looked
    up as it is."""
    tokens = tokens.long()
    r = _live()
    if r is None or table.shape[0] == vocab_size:
        return table[tokens]
    n = table.shape[0]
    local = tokens - r.rank * n
    hit = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)]
    out = torch.where(hit[..., None], rows, torch.zeros_like(rows))
    return all_reduce(out, "embed")


def vocab_logits(local: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Full-vocabulary logits from this rank's ``(..., V / tp)`` slice:
    each rank writes its slice into a zero-filled ``(..., V)`` buffer and
    one sum assembles it. Logits already over the whole vocabulary are
    returned as they are."""
    r = _live()
    n = local.shape[-1]
    if r is None or n == vocab_size:
        return local
    out = local.new_zeros(local.shape[:-1] + (vocab_size,))
    out[..., r.rank * n:(r.rank + 1) * n] = local
    return all_reduce(out, "logits")


def gather_heads(parts, heads, what: str):
    """Every rank's heads of the tensors in ``parts``, each ``(..., h,
    D)`` of this rank's ``h`` consecutive heads of ``heads[i]``,
    assembled by ONE sum: each rank writes its heads into a zero-filled
    buffer of all of them (exact: only zeros are added). A tensor that
    already has all its heads is returned as it is and not sent."""
    r = _live()
    out = list(parts)
    todo = [i for i, x in enumerate(parts) if x.shape[-2] != heads[i]]
    if r is None or not todo:
        return out
    shapes = [parts[i].shape[:-2] + (heads[i], parts[i].shape[-1])
              for i in todo]
    buf = parts[todo[0]].new_zeros(sum(math.prod(sh) for sh in shapes))
    at = 0
    for i, sh in zip(todo, shapes):
        full = buf[at:at + math.prod(sh)].view(sh)
        at += full.numel()
        h = parts[i].shape[-2]
        full[..., r.rank * h:(r.rank + 1) * h, :] = parts[i]
        out[i] = full
    all_reduce(buf, what)
    return out


def kv_read(x: torch.Tensor) -> torch.Tensor:
    """The KV heads the current rank's query heads read, of a K or V
    tensor whose second-to-last axis is the cache's heads."""
    r = _live()
    if r is None or r.kv_read is None:
        return x
    return x[..., r.kv_read, :]


def check_training(what: str):
    """Raise ``NotImplementedError`` naming item 11 when a rank is
    current: sharded training waits for a later step."""
    if _live() is not None:
        raise NotImplementedError(
            f"{what} under a tensor-parallel mesh: sharded training waits "
            "for the parallelism slice, ROADMAP.md Queue 1 item 11")


# ------------------------------------------------------- sharding leaves

def rank_pspecs(params, strategy, mesh, cfg):
    """``core/sharding.param_pspecs`` with every head kept whole: a
    query, key or value projection (and ``wo``) whose head count does not
    divide the "model" axis stays replicated where the table would split
    its flattened ``heads * head_dim`` dimension."""
    model = mesh_axes(mesh).get("model", 1)
    counts = {"heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads}

    def whole(path, leaf, spec):
        logical = param_logical(path, leaf)
        return P(*(None if ax is not None and logical[i] in counts
                   and counts[logical[i]] % model else ax
                   for i, ax in enumerate(spec)))

    return tree_map_with_path(whole, params,
                              param_pspecs(params, strategy, mesh))


def coordinate(mesh) -> Dict[str, int]:
    """The calling rank's coordinate on each axis of ``mesh``."""
    return {n: int(mesh[n].get_local_rank()) for n in mesh.mesh_dim_names}


def _parts(ax, axes: Dict[str, int], coord: Dict[str, int]):
    """(number of blocks, this rank's block) of a dim sharded over
    ``ax`` (an axis name or a tuple of them, major first)."""
    size, index = 1, 0
    for a in (ax if isinstance(ax, tuple) else (ax,)):
        size, index = size * axes[a], index * axes[a] + coord.get(a, 0)
    return size, index


def local_shape(shape, spec, axes: Dict[str, int]) -> tuple:
    """The block shape of a leaf of ``shape`` under ``spec``."""
    return tuple(n if ax is None else n // _parts(ax, axes, {})[0]
                 for n, ax in zip(shape, spec))


def shard_leaf(leaf: torch.Tensor, spec, axes: Dict[str, int],
               coord: Dict[str, int]) -> torch.Tensor:
    """The block of ``leaf`` at mesh coordinate ``coord`` under ``spec``
    (``axes``: the mesh's sizes), as a contiguous tensor."""
    out = leaf
    for dim, ax in enumerate(spec):
        if ax is not None:
            size, index = _parts(ax, axes, coord)
            n = leaf.shape[dim] // size
            out = out.narrow(dim, index * n, n)
    return out.contiguous()


class _Shape:
    """A leaf stand-in: what the tables read of a parameter."""

    def __init__(self, shape):
        self.shape = tuple(shape)
        self.ndim = len(self.shape)


def leaf_specs(shapes: Dict[str, tuple], strategy, mesh, cfg):
    """``{key: spec}`` (``rank_pspecs``) for flat ``{key: full shape}``
    parameter shapes."""
    tree = unflatten({k: _Shape(s) for k, s in shapes.items()})
    return flatten(rank_pspecs(tree, strategy, mesh, cfg))


def shard_params(params, shapes: Dict[str, tuple], strategy, mesh, cfg):
    """This rank's block of every leaf of ``params`` (``shapes``: each
    flat key's full shape). A leaf already of its block's shape — made by
    ``params.init_params(shard=)`` or ``from_numpy(shard=)`` — is kept;
    any other shape raises."""
    specs = leaf_specs(shapes, strategy, mesh, cfg)
    axes, coord = mesh_axes(mesh), coordinate(mesh)
    out = {}
    for key, leaf in flatten(params).items():
        full, spec = tuple(shapes[key]), specs[key]
        mine = local_shape(full, spec, axes)
        if tuple(leaf.shape) == full:
            out[key] = shard_leaf(leaf, spec, axes, coord)
        elif tuple(leaf.shape) == mine:
            out[key] = leaf
        else:
            raise ValueError(f"{key}: shape {tuple(leaf.shape)} is neither "
                             f"the full {full} nor this rank's {mine}")
    return unflatten(out)
