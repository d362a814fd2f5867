"""Logical-axis sharding specs — the port of ``repro/core/pspec.py``.

Model code names tensor dimensions by LOGICAL axes ("batch", "heads",
"d_ff", "vocab", ...); a Strategy's rules table maps each onto a mesh axis
or None (``Strategy.rules``). ``logical_to_spec`` turns a tuple of logical
names into a spec: :class:`P`, a plain tuple of mesh-axis entries that
stands for JAX's ``PartitionSpec`` (``tuple(P(...))`` of either compares
equal entry for entry).

The reference's ``constrain`` hands GSPMD a sharding hint for an
activation. The port shards explicitly: every rank holds plain local
shards (``core/tp.py``) and the layers call the collective GSPMD would
have inserted, so there is no hint to give and no ``constrain``.
``sharding_rules`` keeps the reference's active mesh/rules accessors for
code that reads the table by logical name.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Mapping, Optional, Sequence, Union

MeshAxes = Union[None, str, tuple]

_state = threading.local()


class P(tuple):
    """A partition spec: one entry a dimension, each None (replicated),
    a mesh-axis name, or a tuple of mesh-axis names."""

    def __new__(cls, *entries: MeshAxes):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _rules() -> Optional[Mapping[str, MeshAxes]]:
    return getattr(_state, "rules", None)


def _mesh():
    return getattr(_state, "mesh", None)


@contextmanager
def sharding_rules(mesh, rules: Mapping[str, MeshAxes]):
    """Activate a logical->mesh axis mapping (and the mesh) for this
    thread."""
    old = (_rules(), _mesh())
    _state.rules, _state.mesh = dict(rules), mesh
    try:
        yield
    finally:
        _state.rules, _state.mesh = old


def logical_to_spec(axes: Sequence[Optional[str]],
                    rules: Optional[Mapping[str, MeshAxes]] = None) -> P:
    """Map a tuple of logical axis names to a spec."""
    rules = rules if rules is not None else (_rules() or {})
    return P(*[rules.get(a) if a is not None else None for a in axes])
