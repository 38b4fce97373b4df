"""Device meshes: the port of the reference's ``launch/mesh.py``.

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` with named
dims over the initialized default process group (NCCL on the card; gloo,
or the ``fake`` backend for a dry run, on the host).  Defined as
functions, never module-level constants, so importing this module touches
no device or process-group state.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch import compat

__all__ = ["make_production_mesh", "make_local_mesh"]

#: the reference's deployment meshes: shape and dim names
PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialized process group: "
                           "call torch.distributed.init_process_group "
                           "first")
    return dist.get_world_size()


def _mesh(device_type: str, shape: tuple, names: tuple) -> DeviceMesh:
    ranks = torch.arange(_world(), dtype=torch.int64).reshape(shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=names)


def make_local_mesh(data: int = 1, model: int = 1,
                    device: str | torch.device | None = None) -> DeviceMesh:
    """A ``(data, model)`` mesh over every rank of the process group, on
    ``cuda`` unless ``device`` names another (never a silent fall back to
    the host: :func:`repro_torch.compat.resolve_device`).  ``data * model``
    must be the world size."""
    dev = compat.resolve_device(device)
    world = _world()
    if data * model != world:
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} "
                         f"ranks; the process group has {world}")
    return _mesh(dev.type, (data, model), ("data", "model"))


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """The target deployment mesh.

    Single pod: 256 ranks as (data=16, model=16).  Multi-pod: 2 x 256 as
    (pod=2, data=16, model=16); the ``pod`` dim is the slow tier, batch
    shards across it, and the ``fsdp_pods`` profile spreads ZeRO-3 across
    it too.  The process group must have exactly that many ranks (the
    ``fake`` backend gives them to one process for a dry run); any other
    world size raises.  The mesh is on ``cuda`` under NCCL and on ``cpu``
    under any other backend.
    """
    shape, names = PRODUCTION[multi_pod]
    need = 1
    for n in shape:
        need *= n
    world = _world()
    if world != need:
        raise ValueError(f"the production mesh {dict(zip(names, shape))} "
                         f"needs a world of {need} ranks; the process "
                         f"group has {world}")
    return _mesh("cuda" if dist.get_backend() == "nccl" else "cpu", shape,
                 names)
