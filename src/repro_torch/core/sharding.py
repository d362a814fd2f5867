"""Parameter and state sharding tables (Megatron §5.1) — the port of
``repro/core/sharding.py``, as pure functions of leaf names, leaf shapes
and the mesh's ``{axis: size}``.

``param_logical(path, leaf)`` maps every parameter to logical axes by its
name; a Strategy's rules table then yields specs (``core/pspec.P``). The
rules encode the survey's §5.1 scheme exactly:

  * MLP: A (w_gate/w_up) split over COLUMNS (d_ff), B (w_down) over ROWS
    (d_ff) => the SwiGLU is local and the forward needs ONE all-reduce;
  * attention: wq/wk/wv column-split by head, wo row-split;
  * embedding / LM head: vocab-split (Megatron vocab-parallel);
  * MoE: the expert axis split (expert parallelism), or TP inside each
    expert when ``Strategy.expert_parallel=False``;
  * Mamba2: in_proj column-split, out_proj row-split.

Trees are nested dicts (lists and tuples too) whose leaves carry
``.shape`` and ``.ndim``: torch tensors, numpy arrays, or shape
stand-ins (``jax.ShapeDtypeStruct`` in the parity tests). ``mesh`` is a
``DeviceMesh`` or an ``{axis: size}`` mapping (``strategy.mesh_axes``),
so the tables run without a process group. The serving engine reads
``param_pspecs`` and ``cache_pspecs``; the trainer on a mesh reads
``param_pspecs`` (through ``core/tp.py::rank_pspecs``), ``zero1_spec``
and ``_state_leaf_spec`` (``opt_state_pspecs``' rule a leaf) for the
blocks a rank holds and updates.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

from repro_torch.core.pspec import P, logical_to_spec
from repro_torch.core.strategy import Strategy, mesh_axes

# leaf name -> logical axes of the TRAILING dims (leading dims — the
# stacked layer axes — are unsharded)
_TRAILING = {
    # attention (column for qkv, row for o)
    "wq": ("d_model", "heads"),
    "wk": ("d_model", "kv_heads"),
    "wv": ("d_model", "kv_heads"),
    "wo": ("heads", "d_model"),
    # dense MLP (column, column, row)
    "w_gate": ("d_model", "d_ff"),
    "w_up": ("d_model", "d_ff"),
    "w_down": ("d_ff", "d_model"),
    # embeddings (vocab-parallel)
    "embed": ("vocab", "d_model"),
    "tok_embed": ("vocab", "d_model"),
    "lm_head": ("d_model", "vocab"),
    # MoE
    "router": ("d_model", None),
    # Mamba2
    "in_proj": ("d_model", "ssm_inner"),
    "out_proj": ("ssm_inner", "d_model"),
    "conv_w": (None, "ssm_inner"),
    "conv_b": ("ssm_inner",),
    "dt_bias": ("ssm_heads",),
    "A_log": ("ssm_heads",),
    "D": ("ssm_heads",),
    "gn_scale": ("ssm_inner",),
}

# MoE expert tensors, keyed by leaf name under a "moe" parent
_MOE_TRAILING = {
    "w_gate": ("experts", "d_model", "d_ff_moe"),
    "w_up": ("experts", "d_model", "d_ff_moe"),
    "w_down": ("experts", "d_ff_moe", "d_model"),
}

_REPLICATED_NAMES = {"ln1", "ln2", "lnx", "norm", "final_norm", "enc_norm",
                     "q_norm", "k_norm", "gate_attn", "gate_mlp"}


def tree_map_with_path(fn, tree, *rest, path: Tuple[str, ...] = ()):
    """``fn(path, leaf, *rest_leaves)`` over the leaves of ``tree`` (dicts,
    lists and tuples), ``path`` the tuple of keys (indices as strings)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest),
                                      path=path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, *(r[i] for r in rest),
                                             path=path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree, *rest)


def param_logical(path, leaf) -> Tuple[Optional[str], ...]:
    """Logical axes for one parameter leaf (padded with None on the left
    for the stacked leading dims). ``path``: its tuple of keys."""
    names = tuple(path)
    leaf_name = names[-1]
    if leaf_name in _REPLICATED_NAMES:
        return (None,) * leaf.ndim
    if leaf_name in _MOE_TRAILING and "moe" in names:
        trailing = _MOE_TRAILING[leaf_name]
    elif leaf_name in _TRAILING:
        trailing = _TRAILING[leaf_name]
    else:
        return (None,) * leaf.ndim
    pad = leaf.ndim - len(trailing)
    if pad < 0:
        raise ValueError(f"{'/'.join(names)}: shape {tuple(leaf.shape)} "
                         f"has fewer dims than {trailing}")
    return (None,) * pad + tuple(trailing)


def _axis_size(ax, axes) -> int:
    size = 1
    for a in (ax if isinstance(ax, tuple) else (ax,)):
        size *= axes[a]
    return size


def _divisible(shape, spec: P, mesh) -> P:
    """Drop shardings that don't divide (parameters take exact shardings
    only)."""
    axes = mesh_axes(mesh)
    new = []
    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    for dim, ax in zip(shape, entries):
        new.append(None if ax is None or dim % _axis_size(ax, axes)
                   else ax)
    return P(*new)


def param_pspecs(params: Any, strategy: Strategy, mesh):
    """Tree of specs matching ``params``."""
    rules = strategy.rules(mesh)

    def one(path, leaf):
        spec = logical_to_spec(param_logical(path, leaf), rules)
        spec = _divisible(leaf.shape, spec, mesh)
        if strategy.fsdp:
            # ZeRO-3/FSDP: additionally shard over "data" on the first
            # free divisible dim
            spec = zero1_spec(spec, leaf.shape, mesh)
        return spec

    return tree_map_with_path(one, params)


def zero1_spec(spec: P, shape, mesh, axis: str = "data") -> P:
    """ZeRO-1: additionally shard an optimizer-state tensor over ``axis``
    on the first unsharded, divisible dim (DeepSpeed-style)."""
    axes = mesh_axes(mesh)
    if axis not in axes:
        return spec
    entries = list(tuple(spec) + (None,) * (len(shape) - len(spec)))
    used = set()
    for ax in entries:
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            if a is not None:
                used.add(a)
    if axis in used:            # already sharded over it (FSDP + ZeRO-1)
        return P(*entries)
    for i, (dim, ax) in enumerate(zip(shape, entries)):
        if ax is None and dim % axes[axis] == 0:
            entries[i] = axis
            return P(*entries)
    return spec


def _state_leaf_spec(state_leaf, param_leaf, spec: P, mesh,
                     zero1: bool) -> P:
    """Spec for an optimizer-state leaf derived from its parameter's spec:
    full-shape (m / v / master), row-factored (vr = shape[:-1]) and
    col-factored (vc = shape[:-2] + shape[-1:]) Adafactor states."""
    pshape, sshape = tuple(param_leaf.shape), tuple(state_leaf.shape)
    entries = tuple(spec) + (None,) * (len(pshape) - len(spec))
    if sshape == pshape:
        out = P(*entries)
    elif len(pshape) >= 2 and sshape == pshape[:-1]:
        out = P(*entries[:-1])
    elif len(pshape) >= 2 and sshape == pshape[:-2] + pshape[-1:]:
        out = P(*(entries[:-2] + entries[-1:]))
    elif sshape == ():
        return P()
    else:
        out = P(*([None] * len(sshape)))
    if zero1:
        out = zero1_spec(out, sshape, mesh)
    return _divisible(sshape, out, mesh)


def opt_state_pspecs(opt_state, params, strategy: Strategy, mesh):
    """Specs matching the optimizer-state tree (AdamW m / v / master or
    Adafactor vr / vc), ZeRO-1-sharded over "data" when enabled."""
    pspecs = param_pspecs(params, strategy, mesh)
    out = {}
    for k, sub in opt_state.items():
        if k == "step":
            out[k] = P()
        else:
            out[k] = tree_map_with_path(
                lambda _, s, p, sp: _state_leaf_spec(s, p, sp, mesh,
                                                     strategy.zero1),
                sub, params, pspecs)
    return out


# ---------------------------------------------------------------- caches

def cache_pspecs(cache: Any, strategy: Strategy, mesh, batch: int):
    """KV / SSM cache specs: batch over data (when divisible), heads over
    model. Layouts: kv k/v (L, B, W, Hkv, D); ssm state (L, B, H, P, N);
    conv (L, B, W, C); xkv like kv.

    A cache carrying a ``"ptab"`` page table (the serving engine's paged
    layout) holds its decoder KV as one flat POOL (L, n_pages, page_size,
    Hkv, D): head-sharded over "model" (each device keeps Hkv/tp heads of
    EVERY page), replicated where the heads do not divide, and never
    batch-sharded; the page table and the dense leaves beside it keep
    their usual specs. Dense K/V rows whose heads do not divide the model
    axis shard their SEQUENCE dim instead (the reference's context-parallel
    decode)."""
    rules = strategy.rules(mesh)
    axes = mesh_axes(mesh)
    dp = 1
    for a in ("pod", "data"):
        dp *= axes.get(a, 1)
    bspec = rules["batch"] if batch % dp == 0 else None
    model_size = axes.get("model", 1)
    paged = isinstance(cache, dict) and "ptab" in cache

    def one(path, leaf):
        names = tuple(path)
        if leaf.ndim == 0 or names[-1] == "pos":
            return P()
        if paged and names[0] == "kv" and names[-1] in ("k", "v"):
            spec = P(None, None, None,
                     rules["kv_heads"] if leaf.shape[3] % model_size == 0
                     else None, None)
            return _divisible(leaf.shape, spec, mesh)
        if names[-1] in ("k", "v"):
            if leaf.shape[3] % model_size == 0:
                spec = P(None, bspec, None, rules["kv_heads"], None)
            elif leaf.shape[2] % model_size == 0:
                spec = P(None, bspec, "model", None, None)
            else:
                spec = P(None, bspec, None, None, None)
        elif names[-1] == "state":
            spec = P(None, bspec, rules["ssm_heads"], None, None)
        elif names[-1] == "conv":
            spec = P(None, bspec, None, rules["ssm_inner"])
        else:
            spec = P(*([None] * leaf.ndim))
        return _divisible(leaf.shape, spec, mesh)

    return tree_map_with_path(one, cache)
