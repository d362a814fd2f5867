"""Parameters of the ported families: random init at the reference's
shapes, scales and dtypes, and the weight bridge from the JAX package's
trees and checkpoints.

The dense decoder's tree mirrors ``repro/models/transformer.py::init``
(with ``layers.py::dense_init``, ``init_attn`` and ``init_mlp``): nested
dicts, per-layer weights stacked on a leading L axis, matrices ``normal *
0.02`` except ``wo`` and ``w_down`` at ``0.02 / sqrt(2L)``, norm scales
fp32 ones, matrices in ``cfg.dtype``. The MoE decoder's is the dense
one with ``moe/`` in place of ``mlp/`` (``repro/models/moe.py::init_moe``):
``router`` ``(d, E)`` fp32, ``w_gate`` and ``w_up`` ``(E, d, f)``,
``w_down`` ``(E, f, d)`` at ``0.02 / sqrt(2L)``. The SSM family's mirrors
``repro/models/mamba_lm.py::init`` and ``ssm.py::init_mamba``: the same
embedding, head and norms, and per layer ``in_proj`` ``(d, 2 din + 2N +
H)``, ``conv_w`` fp32 ``normal * 0.5``, ``conv_b`` zeros, ``dt_bias`` and
``A_log`` deterministic ``linspace`` formulas, ``D`` and ``gn_scale``
ones, ``out_proj`` at ``0.02 / sqrt(2L)``. The hybrid's mirrors
``repro/models/hybrid.py::init``: the same Mamba2 layers stacked ``(G,
every, ...)`` under ``groups/`` and ``(max(rest, 1), ...)`` under
``trailing/`` (with ``rest == 0`` the reference still keeps one unused
trailing layer), and ONE shared attention + SwiGLU block under
``shared/``. The enc-dec audio family's mirrors
``repro/models/encdec.py::init``: ``tok_embed``, ``enc_layers/`` and
``dec_layers/`` stacked on their own depths (attention, in the decoder
also ``xattn``, and the plain-GeLU MLP's ``w_up`` and ``w_down``; ``wo``
and ``w_down`` at ``0.02 / sqrt(2L)`` with L the decoder's depth in both
stacks), ``enc_norm``, ``final_norm`` and an untied ``lm_head``. The
VLM's mirrors ``repro/models/vlm.py::init``: the dense decoder's layers
stacked ``(G, cross_attn_every, ...)`` under ``self_groups/``, one gated
cross-attention layer a group stacked ``(G, ...)`` under ``cross/``
(``xattn``, the SwiGLU ``mlp``, the norms ``lnx`` and ``ln2``, and the
fp32 gates ``gate_attn`` and ``gate_mlp``, zero at init), ``(max(rest,
1), ...)`` dense layers under ``trailing/`` (one unused layer when
``rest == 0``, as the reference keeps), the embedding, ``final_norm`` and
an untied ``lm_head``. Leaves are keyed by the ``"/"``-joined paths of
``repro/checkpoint/io.py::_flatten`` (``layers/attn/wq``,
``groups/mamba/in_proj``, ...), which is the bridge's key map.

The random draws are the port's own (``torch.Generator``), not
``jax.random``'s: parity tests initialise in JAX and load the tree here.
"""
from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, Tuple, Union

import numpy as np
import torch

from repro_torch.core import tp
from repro_torch.core.strategy import mesh_axes
from repro_torch.tree import unflatten

#: key -> (shape, dtype, init): init is the std of a normal draw, or one
#: of the kinds of :data:`FIXED_INITS`
Spec = Dict[str, Tuple[tuple, torch.dtype, Union[float, str]]]


def _linspace(start: float, stop: float, num: int):
    """``jnp.linspace(start, stop, num, dtype=float32)``'s formula in fp32
    (``start * (1 - step) + stop * step``, the last entry ``stop``);
    XLA may round an entry one ulp apart."""
    step = torch.arange(num - 1, dtype=torch.float32) / (num - 1)
    out = torch.tensor(start, dtype=torch.float32) * (1 - step) \
        + torch.tensor(stop, dtype=torch.float32) * step
    return torch.cat([out, torch.tensor([stop], dtype=torch.float32)])


#: deterministic leaves: kind -> (shape -> fp32 CPU tensor)
FIXED_INITS = {
    "ones": lambda shape: torch.ones(shape),
    "zeros": lambda shape: torch.zeros(shape),
    # ssm.py::init_mamba, per layer, stacked on L
    "dt_bias": lambda shape: torch.log(torch.expm1(
        _linspace(1e-3, 1e-1, shape[-1]))).expand(shape),
    "a_log": lambda shape: torch.log(
        _linspace(1.0, 16.0, shape[-1])).expand(shape),
}


#: stacked leaves: top-level key -> leading layer axes, drawn one layer at
#: a time by :func:`init_params`
STACK_AXES = {"layers": 1, "groups": 2, "trailing": 1, "enc_layers": 1,
              "dec_layers": 1, "self_groups": 2, "cross": 1}


def _mamba_spec(cfg, prefix: str, lead: tuple) -> Spec:
    """Mamba2 layers (``mamba_lm.py::init_layer``) stacked on ``lead``."""
    dt = getattr(torch, cfg.dtype)
    f32 = torch.float32
    d, h, n, w = cfg.d_model, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_conv_width
    din = h * cfg.ssm_head_dim
    ch = din + 2 * n
    return {
        f"{prefix}/norm": (lead + (d,), f32, "ones"),
        f"{prefix}/mamba/in_proj": (lead + (d, 2 * din + 2 * n + h), dt, 0.02),
        f"{prefix}/mamba/conv_w": (lead + (w, ch), f32, 0.5),
        f"{prefix}/mamba/conv_b": (lead + (ch,), f32, "zeros"),
        f"{prefix}/mamba/dt_bias": (lead + (h,), f32, "dt_bias"),
        f"{prefix}/mamba/A_log": (lead + (h,), f32, "a_log"),
        f"{prefix}/mamba/D": (lead + (h,), f32, "ones"),
        f"{prefix}/mamba/gn_scale": (lead + (din,), f32, "ones"),
        f"{prefix}/mamba/out_proj": (lead + (din, d), dt,
                                     0.02 / math.sqrt(2 * cfg.num_layers)),
    }


def _attn_spec(cfg, prefix: str, lead: tuple) -> Spec:
    """``init_attn``'s leaves stacked on ``lead``: ``wo`` at ``0.02 /
    sqrt(2L)``, L the decoder's depth in every stack."""
    dt = getattr(torch, cfg.dtype)
    d = cfg.d_model
    spec: Spec = {
        f"{prefix}/wq": (lead + (d, cfg.q_dim), dt, 0.02),
        f"{prefix}/wk": (lead + (d, cfg.kv_dim), dt, 0.02),
        f"{prefix}/wv": (lead + (d, cfg.kv_dim), dt, 0.02),
        f"{prefix}/wo": (lead + (cfg.q_dim, d), dt,
                         0.02 / math.sqrt(2 * cfg.num_layers)),
    }
    if cfg.qk_norm:
        spec[f"{prefix}/q_norm"] = (lead + (cfg.head_dim,), torch.float32,
                                    "ones")
        spec[f"{prefix}/k_norm"] = (lead + (cfg.head_dim,), torch.float32,
                                    "ones")
    return spec


def _encdec_spec(cfg) -> Spec:
    """``repro/models/encdec.py::init``: the encoder's layers (attention,
    plain-GeLU MLP ``w_up``/``w_down``, two norms) stacked on its depth,
    the decoder's (self- and cross-attention, the MLP, three norms) on
    its own, the embedding, the two final norms and an untied head."""
    dt = getattr(torch, cfg.dtype)
    f32 = torch.float32
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    deep = 0.02 / math.sqrt(2 * cfg.num_layers)
    spec: Spec = {"tok_embed": ((v, d), dt, 0.02)}
    for stack, lead, norms, attns in (
            ("enc_layers", (cfg.encoder_layers,), ("ln1", "ln2"),
             ("attn",)),
            ("dec_layers", (cfg.num_layers,), ("ln1", "lnx", "ln2"),
             ("attn", "xattn"))):
        for a in attns:
            spec.update(_attn_spec(cfg, f"{stack}/{a}", lead))
        spec[f"{stack}/mlp/w_up"] = (lead + (d, f), dt, 0.02)
        spec[f"{stack}/mlp/w_down"] = (lead + (f, d), dt, deep)
        for n in norms:
            spec[f"{stack}/{n}"] = (lead + (d,), f32, "ones")
    spec["enc_norm"] = ((d,), f32, "ones")
    spec["final_norm"] = ((d,), f32, "ones")
    spec["lm_head"] = ((d, v), dt, 0.02)
    return spec


def _block_spec(cfg, prefix: str, lead: tuple) -> Spec:
    """Attention + FFN blocks (``init_attn``, the two norms, and
    ``init_mlp``'s SwiGLU or, on an MoE config, ``init_moe``'s router and
    experts) stacked on ``lead``."""
    dt = getattr(torch, cfg.dtype)
    f32 = torch.float32
    d, f = cfg.d_model, cfg.d_ff
    deep = 0.02 / math.sqrt(2 * cfg.num_layers)
    spec: Spec = {**_attn_spec(cfg, f"{prefix}/attn", lead),
                  f"{prefix}/ln1": (lead + (d,), f32, "ones"),
                  f"{prefix}/ln2": (lead + (d,), f32, "ones")}
    if cfg.is_moe:
        e = cfg.num_experts
        spec.update({
            f"{prefix}/moe/router": (lead + (d, e), f32, 0.02),
            f"{prefix}/moe/w_gate": (lead + (e, d, f), dt, 0.02),
            f"{prefix}/moe/w_up": (lead + (e, d, f), dt, 0.02),
            f"{prefix}/moe/w_down": (lead + (e, f, d), dt, deep),
        })
    else:
        spec.update(_mlp_spec(cfg, f"{prefix}/mlp", lead))
    return spec


def _mlp_spec(cfg, prefix: str, lead: tuple) -> Spec:
    """``init_mlp``'s SwiGLU stacked on ``lead``: ``w_down`` at ``0.02 /
    sqrt(2L)``."""
    dt = getattr(torch, cfg.dtype)
    d, f = cfg.d_model, cfg.d_ff
    return {f"{prefix}/w_gate": (lead + (d, f), dt, 0.02),
            f"{prefix}/w_up": (lead + (d, f), dt, 0.02),
            f"{prefix}/w_down": (lead + (f, d), dt,
                                 0.02 / math.sqrt(2 * cfg.num_layers))}


def _vlm_spec(cfg) -> Spec:
    """``repro/models/vlm.py::init`` and ``init_cross_layer``."""
    dt = getattr(torch, cfg.dtype)
    f32 = torch.float32
    d, v = cfg.d_model, cfg.vocab_size
    g, rest = cfg.vlm_groups
    spec: Spec = {"embed": ((v, d), dt, 0.02)}
    spec.update(_block_spec(cfg, "self_groups", (g, cfg.cross_attn_every)))
    spec.update(_attn_spec(cfg, "cross/xattn", (g,)))
    spec.update(_mlp_spec(cfg, "cross/mlp", (g,)))
    spec.update({
        "cross/lnx": ((g, d), f32, "ones"),
        "cross/ln2": ((g, d), f32, "ones"),
        "cross/gate_attn": ((g,), f32, "zeros"),
        "cross/gate_mlp": ((g,), f32, "zeros"),
    })
    spec.update(_block_spec(cfg, "trailing", (max(rest, 1),)))
    spec["final_norm"] = ((d,), f32, "ones")
    spec["lm_head"] = ((d, v), dt, 0.02)
    return spec


def param_spec(cfg) -> Spec:
    """Every leaf of the family's tree, in ``_flatten`` key form."""
    if cfg.arch_type == "audio":
        return _encdec_spec(cfg)
    if cfg.arch_type == "vlm":
        return _vlm_spec(cfg)
    dt = getattr(torch, cfg.dtype)
    d, v = cfg.d_model, cfg.vocab_size
    spec: Spec = {"embed": ((v, d), dt, 0.02),
                  "final_norm": ((d,), torch.float32, "ones")}
    head = {"lm_head": ((d, v), dt, 0.02)}
    if cfg.arch_type in ("dense", "moe"):
        spec.update(_block_spec(cfg, "layers", (cfg.num_layers,)))
        return spec if cfg.tie_embeddings else {**spec, **head}
    # the SSM family and the hybrid draw the head before the layers
    spec.update(head)
    if cfg.arch_type == "ssm":
        return {**spec, **_mamba_spec(cfg, "layers", (cfg.num_layers,))}
    g, rest = cfg.hybrid_groups
    return {**spec,
            **_mamba_spec(cfg, "groups", (g, cfg.hybrid_attn_every)),
            **_mamba_spec(cfg, "trailing", (max(rest, 1),)),
            **_block_spec(cfg, "shared", ())}


def _rank_blocks(cfg, shard):
    """For ``shard=(strategy, mesh)``: a function giving this rank's block
    of a full leaf (``core/tp.py::rank_pspecs``' spec at its coordinate),
    one giving a leaf's block shape, and one giving where a leading index
    of a stacked leaf lies in the rank's block (None where another rank
    holds it: FSDP splits the layer axis over "data"); None, None, None
    unsharded."""
    if shard is None:
        return None, None, None
    strategy, mesh = shard
    specs = tp.leaf_specs(full_shapes(cfg), strategy, mesh, cfg)
    axes, coord = mesh_axes(mesh), tp.coordinate(mesh)

    def block(key, leaf, lead: int = 0):
        return tp.shard_leaf(leaf, specs[key][lead:], axes, coord)

    def block_shape(key, shape):
        return tp.local_shape(shape, specs[key], axes)

    def local_index(key, index, shape):
        out = []
        for i, ax, n in zip(index, tuple(specs[key]), shape):
            if ax is None:
                out.append(i)
                continue
            size, mine = tp.block_of(ax, axes, coord)
            per = n // size
            if i // per != mine:
                return None
            out.append(i % per)
        return tuple(out)

    return block, block_shape, local_index


def full_shapes(cfg) -> Dict[str, tuple]:
    """``{key: shape}`` of every leaf of the family's tree."""
    return {k: v[0] for k, v in param_spec(cfg).items()}


def init_params(cfg, *, device="cuda", generator=None, seed: int = 0,
                shard=None):
    """Random weights on ``device`` from ``generator`` (or a fresh one
    seeded with ``seed``). Stacked weights (:data:`STACK_AXES`) are drawn
    one layer at a time so the fp32 draw never holds more than one
    layer. ``shard=(strategy, mesh)`` keeps only this rank's block of
    every leaf (``core/tp.py``): each layer is drawn whole, as unsharded,
    and sliced, so every rank's blocks are blocks of the same weights and
    the device never holds more than the rank's share and one layer's
    draw (where FSDP splits the layer axis over "data", a rank draws every
    layer and keeps its own)."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    block, block_shape, local_index = _rank_blocks(cfg, shard)
    flat = {}
    for key, (shape, dtype, init) in param_spec(cfg).items():
        if isinstance(init, str):
            leaf = FIXED_INITS[init](shape)
            if block is not None:
                leaf = block(key, leaf)
            flat[key] = leaf.to(device=device, dtype=dtype).contiguous()
            continue
        lead = STACK_AXES.get(key.split("/", 1)[0], 0)
        out = torch.empty(shape if block is None else block_shape(key, shape),
                          dtype=dtype, device=device)
        for index in np.ndindex(*shape[:lead]):
            draw = torch.randn(shape[lead:], generator=generator,
                               device=device) * init
            if block is None:
                out[index].copy_(draw)
                continue
            at = local_index(key, index, shape[:lead])
            if at is not None:
                out[at].copy_(block(key, draw, lead))
        flat[key] = out
    return unflatten(flat)


def _to_tensor(key: str, arr: np.ndarray, dtype: torch.dtype):
    if dtype == torch.bfloat16:
        # ml_dtypes' bfloat16, or the raw void16 an .npz load gives back
        if arr.dtype.kind != "V" or arr.dtype.itemsize != 2:
            raise TypeError(f"{key}: expected bfloat16, got {arr.dtype}")
        return torch.from_numpy(
            np.array(arr).view(np.int16)).view(torch.bfloat16)
    want = np.dtype(str(dtype).removeprefix("torch."))
    if arr.dtype != want:
        raise TypeError(f"{key}: expected {want}, got {arr.dtype}")
    return torch.from_numpy(np.array(arr))


def from_numpy(flat: Dict[str, np.ndarray], cfg, device="cuda",
               shard=None) -> dict:
    """The JAX tree flattened to numpy (``checkpoint/io.py::_flatten``
    keys) -> the port's tree on ``device``. Total: every JAX leaf is
    consumed and every port parameter filled, with shapes and dtypes
    checked — anything else raises. ``shard=(strategy, mesh)`` puts only
    this rank's block of each leaf on the device, a leaf at a time (a
    Mamba2 block's ``in_proj`` and conv laid out by head: the rank's
    columns of ``z``, ``x`` and ``dt`` with all of ``B`` and ``C``,
    ``core/tp.py::Segmented``)."""
    spec = param_spec(cfg)
    missing = sorted(set(spec) - set(flat))
    extra = sorted(set(flat) - set(spec))
    if missing or extra:
        raise KeyError(f"{cfg.name}: weight bridge keys differ — missing "
                       f"{missing}, unexpected {extra}")
    block, _, _ = _rank_blocks(cfg, shard)
    out = {}
    for key, (shape, dtype, _) in spec.items():
        arr = np.asarray(flat[key])
        if tuple(arr.shape) != shape:
            raise ValueError(f"{key}: shape {tuple(arr.shape)} != {shape}")
        leaf = _to_tensor(key, arr, dtype)
        out[key] = (leaf if block is None else block(key, leaf)).to(device)
    return unflatten(out)


def load_npz(step_dir, cfg, device="cuda") -> dict:
    """Read a ``step_*/arrays.npz`` written by ``checkpoint/io.py``."""
    with np.load(Path(step_dir) / "arrays.npz") as data:
        flat = {k: data[k] for k in data.files}
    return from_numpy(flat, cfg, device)
