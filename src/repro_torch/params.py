"""Parameters of the dense decoder: random init at the reference's shapes,
scales and dtypes, and the weight bridge from the JAX package's trees and
checkpoints.

The tree mirrors ``repro/models/transformer.py::init`` (with
``layers.py::dense_init``, ``init_attn`` and ``init_mlp``): nested dicts,
per-layer weights stacked on a leading L axis, matrices ``normal * 0.02``
except ``wo`` and ``w_down`` at ``0.02 / sqrt(2L)``, norm scales fp32
ones, matrices in ``cfg.dtype``. Leaves are keyed by the ``"/"``-joined
paths of ``repro/checkpoint/io.py::_flatten`` (``layers/attn/wq``, ...),
which is the bridge's key map.

The random draws are the port's own (``torch.Generator``), not
``jax.random``'s: parity tests initialise in JAX and load the tree here.
"""
from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

#: key -> (shape, dtype, std) with std None for a ones-initialised scale
Spec = Dict[str, Tuple[tuple, torch.dtype, float]]


def param_spec(cfg) -> Spec:
    """Every leaf of the dense decoder's tree, in ``_flatten`` key form."""
    if cfg.arch_type != "dense" or cfg.is_moe:
        raise NotImplementedError(
            f"{cfg.name}: the port holds dense-decoder params only so far "
            f"({cfg.arch_type} waits for ROADMAP.md Queue 1 item 10)")
    dt = getattr(torch, cfg.dtype)
    f32 = torch.float32
    L, d, f, v = cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size
    deep = 0.02 / math.sqrt(2 * L)
    spec: Spec = {
        "embed": ((v, d), dt, 0.02),
        "final_norm": ((d,), f32, None),
        "layers/attn/wq": ((L, d, cfg.q_dim), dt, 0.02),
        "layers/attn/wk": ((L, d, cfg.kv_dim), dt, 0.02),
        "layers/attn/wv": ((L, d, cfg.kv_dim), dt, 0.02),
        "layers/attn/wo": ((L, cfg.q_dim, d), dt, deep),
        "layers/ln1": ((L, d), f32, None),
        "layers/ln2": ((L, d), f32, None),
        "layers/mlp/w_gate": ((L, d, f), dt, 0.02),
        "layers/mlp/w_up": ((L, d, f), dt, 0.02),
        "layers/mlp/w_down": ((L, f, d), dt, deep),
    }
    if cfg.qk_norm:
        spec["layers/attn/q_norm"] = ((L, cfg.head_dim), f32, None)
        spec["layers/attn/k_norm"] = ((L, cfg.head_dim), f32, None)
    if not cfg.tie_embeddings:
        spec["lm_head"] = ((d, v), dt, 0.02)
    return spec


def _unflatten(flat: Dict[str, torch.Tensor]) -> dict:
    tree: dict = {}
    for key, leaf in flat.items():
        *path, last = key.split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[last] = leaf
    return tree


def init_params(cfg, *, device="cuda", generator=None, seed: int = 0):
    """Random weights on ``device`` from ``generator`` (or a fresh one
    seeded with ``seed``). Stacked weights are drawn one layer at a time
    so the fp32 draw never holds more than one layer."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    flat = {}
    for key, (shape, dtype, std) in param_spec(cfg).items():
        if std is None:
            flat[key] = torch.ones(shape, dtype=dtype, device=device)
            continue
        out = torch.empty(shape, dtype=dtype, device=device)
        parts = out if key.startswith("layers/") else out[None]
        for part in parts:
            part.copy_(torch.randn(part.shape, generator=generator,
                                   device=device) * std)
        flat[key] = out
    return _unflatten(flat)


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


def from_numpy(flat: Dict[str, np.ndarray], cfg, device="cuda") -> dict:
    """The JAX tree flattened to numpy (``checkpoint/io.py::_flatten``
    keys) -> the port's tree on ``device``. Total: every JAX leaf is
    consumed and every port parameter filled, with shapes and dtypes
    checked — anything else raises."""
    spec = param_spec(cfg)
    missing = sorted(set(spec) - set(flat))
    extra = sorted(set(flat) - set(spec))
    if missing or extra:
        raise KeyError(f"{cfg.name}: weight bridge keys differ — missing "
                       f"{missing}, unexpected {extra}")
    out = {}
    for key, (shape, dtype, _) in spec.items():
        arr = np.asarray(flat[key])
        if tuple(arr.shape) != shape:
            raise ValueError(f"{key}: shape {tuple(arr.shape)} != {shape}")
        out[key] = _to_tensor(key, arr, dtype).to(device)
    return _unflatten(out)


def load_npz(step_dir, cfg, device="cuda") -> dict:
    """Read a ``step_*/arrays.npz`` written by ``checkpoint/io.py``."""
    with np.load(Path(step_dir) / "arrays.npz") as data:
        flat = {k: data[k] for k in data.files}
    return from_numpy(flat, cfg, device)
