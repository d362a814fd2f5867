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
(``core/pipeline.py`` moves stage outputs along it).
"""
from __future__ import annotations

import math
from typing import Sequence

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
