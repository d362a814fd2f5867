"""Meshes over ``torch.distributed`` ranks — the port of
``repro/launch/mesh.py``. Functions, not module constants: importing this
module touches no process group or device.

A mesh here is a ``torch.distributed.device_mesh.DeviceMesh`` over the
ranks of the initialised default process group (one process a rank, as
``torchrun`` starts them), built with ``init_device_mesh``. The process
group, and with it the backend (gloo or NCCL), is the caller's: these
functions only lay its ranks out on named axes. The device type is
``"cuda"`` unless the caller asks for ``"cpu"``. Only calls that behave
alike on the torch releases the port runs on are used on a mesh:
``mesh[axis].get_local_rank()``, ``mesh[axis].size()``,
``mesh.size(dim)`` and ``mesh.get_group(axis)``.

``make_pipeline_mesh`` adds the inter-operator "pipe" axis between the two
(``core/pipeline.py`` moves stage outputs along it). ``fake_mesh`` lays a
mapping such as ``{"data": 16, "model": 16}`` over a process group that
moves no data, with the calling process as one of its ranks: the dry-run
(``api/session.py::Session.lower``) traces a rank's step on it.
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Mapping, Sequence

import torch.distributed as dist


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over ranks ``0 ..
    prod(shape) - 1`` of the default process group. Raises ``ValueError``
    when no process group is initialised or it has fewer ranks than the
    mesh needs."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    need = math.prod(shape)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    if not dist.is_initialized():
        raise ValueError(
            f"a {'x'.join(map(str, shape))} mesh needs {need} ranks but no "
            "process group is initialised (run under torchrun, or call "
            "torch.distributed.init_process_group first)")
    world = dist.get_world_size()
    if need > world:
        raise ValueError(
            f"a {'x'.join(map(str, shape))} mesh ({dict(zip(axes, shape))}) "
            f"needs {need} ranks but the process group has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(*, model: int = 1, data: int = 0,
                   device_type: str = "cuda"):
    """("data", "model") over every rank of the process group: ``model``
    ranks a replica, ``data`` replicas (0: as many as the ranks make)."""
    if data == 0:
        world = dist.get_world_size() if dist.is_initialized() else 1
        data = max(world // model, 1)
    return make_mesh((data, model), ("data", "model"),
                     device_type=device_type)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The reference's production layout, 16 x 16 ("data", "model");
    ``multi_pod`` adds a 2-pod axis. Intra-operator (tensor) parallelism
    takes the fast innermost "model" axis, data parallelism "data", and
    pods carry data parallelism only (PaLM §5.3)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)


def make_pipeline_mesh(*, data: int, pipe: int, model: int,
                       device_type: str = "cuda"):
    """("data", "pipe", "model") with an explicit inter-operator axis for
    ``core/pipeline.py`` — the survey's hybrid dp x pp x tp layout (Table
    2), ranks laid out row-major as the reference's mesh."""
    return make_mesh((data, pipe, model), ("data", "pipe", "model"),
                     device_type=device_type)


@contextmanager
def fake_mesh(axes: Mapping[str, int], rank: int = 0):
    """A ``DeviceMesh`` of ``axes`` (``{name: size}``, row-major) over a
    process group of ``prod(sizes)`` ranks on PyTorch's ``"fake"``
    backend, whose collectives return at once and move nothing, with the
    calling process as ``rank``. The group is destroyed when the block
    ends, errors included. Raises ``ValueError`` when a process group is
    already initialised: a fake group of hundreds of ranks cannot sit
    beside a caller's default group."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    names = tuple(axes)
    shape = tuple(int(axes[a]) for a in names)
    world = math.prod(shape)
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} is not one of the {world} ranks of "
                         f"{dict(axes)}")
    if dist.is_initialized():
        raise ValueError(
            "a process group is already initialised: the dry-run makes a "
            f"fake group of {world} ranks of its own and cannot run beside "
            "it (call it from a process without one)")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield init_device_mesh("cpu", shape, mesh_dim_names=names)
    finally:
        dist.destroy_process_group()
