"""Nested dicts of tensors (the port's param and optimizer-state trees):
flatten to ``"/"``-joined keys — the keys of the JAX package's
``checkpoint/io.py::_flatten`` — and back, map over leaves, and split stacked leaves."""
from __future__ import annotations

from typing import Callable, Dict


def flatten(tree: dict, prefix: str = "") -> Dict[str, object]:
    """``{"layers": {"attn": {"wq": t}}}`` -> ``{"layers/attn/wq": t}``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def unflatten(flat: Dict[str, object]) -> dict:
    tree: dict = {}
    for key, leaf in flat.items():
        *path, last = key.split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[last] = leaf
    return tree


def tree_map(fn: Callable, tree: dict, *rest: dict) -> dict:
    """``fn`` over the leaves of ``tree`` and the same keys of ``rest``."""
    return {k: tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
            else fn(v, *(r[k] for r in rest)) for k, v in tree.items()}


def unbind_leaves(tree: dict) -> Dict[str, tuple]:
    """Every leaf of ``tree`` split along its leading axis, by flat key:
    the views of ONE ``unbind`` a leaf, whose backward stacks the parts'
    gradients once, where indexing each part would allocate a zero
    gradient of the whole stack per part."""
    return {k: v.unbind(0) for k, v in flatten(tree).items()}
