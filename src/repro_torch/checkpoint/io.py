"""Checkpointing: a tree of tensors -> .npz + JSON manifest, in the layout
of the JAX package's ``repro/checkpoint/io.py``, so each package restores
the other's checkpoints bit for bit.

Layout:  <dir>/step_<n>/arrays.npz    ("/"-joined key path -> array)
         <dir>/step_<n>/manifest.json (step, shape and dtype per leaf)

numpy has no bfloat16 without ``ml_dtypes``, which the port does not use:
a bf16 leaf is written as the 2-byte void view (``|V2``) that an npz
written by JAX holds, and read back through ``params._to_tensor``; the
manifest names it ``bfloat16``, as JAX's does.
"""
from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.params import _to_tensor
from repro_torch.tree import flatten, unflatten


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _flatten(tree) -> dict:
    return {k: _to_numpy(v) for k, v in flatten(tree).items()}


def save_checkpoint(directory, step: int, tree) -> Path:
    d = Path(directory) / f"step_{step:08d}"
    d.mkdir(parents=True, exist_ok=True)
    leaves = flatten(tree)
    np.savez(d / "arrays.npz", **_flatten(tree))
    manifest = {
        "step": step,
        "leaves": {k: {"shape": list(v.shape),
                       "dtype": str(v.dtype).removeprefix("torch.")}
                   for k, v in leaves.items()},
    }
    (d / "manifest.json").write_text(json.dumps(manifest, indent=2))
    return d


def latest_step(directory) -> Optional[int]:
    d = Path(directory)
    if not d.exists():
        return None
    steps = [int(m.group(1)) for p in d.iterdir()
             if (m := re.match(r"step_(\d+)$", p.name))]
    return max(steps) if steps else None


def load_checkpoint(directory, step: int, like, *,
                    block: Optional[Callable] = None):
    """Restore into the keys of ``like``, each leaf on its device and in
    its dtype (shape- and dtype-checked). ``block(key, full)``: the part
    of the full leaf that ``like`` holds (a sharded trainer's rank
    block), cut on the host before it is checked and moved."""
    d = Path(directory) / f"step_{step:08d}"
    flat_like = flatten(like)
    with np.load(d / "arrays.npz") as data:
        missing = set(flat_like) - set(data.files)
        if missing:
            raise ValueError(
                f"checkpoint missing keys: {sorted(missing)[:5]}")
        out = {}
        for key, leaf in flat_like.items():
            t = _to_tensor(key, data[key], leaf.dtype)
            if block is not None:
                t = block(key, t)
            if tuple(t.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch for {key}: "
                                 f"{tuple(t.shape)} vs {tuple(leaf.shape)}")
            out[key] = t.to(leaf.device)
    return unflatten(out)
