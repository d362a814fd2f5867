"""Which branch a tensor takes through a kernel wrapper, and where each
hand-written kernel charges its work.

A CUDA tensor takes the kernel, a CPU tensor its plain version. A tensor
on ``torch.device("meta")`` (the dry-run, ``launch/roofline.py``) takes
the branch of the device it stands in for, named by :func:`as_device`:
``"cuda"`` runs every host check the card's path runs and allocates its
outputs and scratch by the same calls, launching nothing; ``"cpu"`` runs
the plain version on meta tensors. A meta tensor outside ``as_device``
raises: meta is an explicit case, never a fallback.

:func:`charge` hands a kernel's ``cost`` (each kernel module's
``cost(...) -> (flops, bytes)``) to every active sink, on every launch on
the card as on meta. The sinks are process-wide, not per thread: the
autograd engine runs a remat recompute's forward on its own thread.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Callable, List

import torch

_target: List[str] = []
_sinks: List[Callable] = []
_quiet: List[bool] = []


@contextmanager
def as_device(device_type: str):
    """Make meta tensors take ``device_type``'s branch ("cuda" or "cpu")
    until the block ends."""
    device_type = torch.device(device_type).type
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"meta tensors stand in for 'cuda' or 'cpu', not "
                         f"{device_type!r}")
    _target.append(device_type)
    try:
        yield device_type
    finally:
        _target.pop()


def target(t: torch.Tensor) -> str:
    """The device type whose branch ``t`` takes."""
    if not t.is_meta:
        return t.device.type
    if not _target:
        raise ValueError(
            "a meta tensor reached a kernel wrapper outside "
            "kernels.dispatch.as_device(...): say which device's branch it "
            "stands in for")
    return _target[-1]


def on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` takes the card's branch: a CUDA tensor, or a meta
    tensor standing in for one."""
    return target(t) == "cuda"


@contextmanager
def sink(fn: Callable):
    """Call ``fn(name, flops, nbytes, scratch_bytes)`` for every kernel
    launch (or meta stand-in of one) until the block ends."""
    _sinks.append(fn)
    try:
        yield fn
    finally:
        _sinks.remove(fn)


def charge(name: str, cost, scratch: int = 0) -> None:
    """Hand kernel ``name``'s ``(flops, bytes)`` (or a function of no
    argument giving them, called only when a sink is active: a cost that
    reads the data syncs with the card) and the scratch bytes its wrapper
    allocated to every active sink."""
    if not _sinks:
        return
    if callable(cost):
        _quiet.append(True)
        try:
            cost = cost()
        finally:
            _quiet.pop()
    flops, nbytes = cost
    for fn in list(_sinks):
        fn(name, float(flops), float(nbytes), int(scratch))


def quiet() -> bool:
    """Whether the ops running now compute a kernel's cost, not the step's
    work (a counter leaves them out)."""
    return bool(_quiet)
