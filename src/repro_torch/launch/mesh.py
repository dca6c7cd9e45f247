"""Production meshes (``repro/launch/mesh.py``) as ``DeviceMesh``es.

Defined as FUNCTIONS so importing this module touches no device and no
process group.  Both need a process group of the mesh's size already
initialised (``torch.distributed.init_process_group``); neither makes one.
"""
from __future__ import annotations

from typing import Optional

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..core.config import resolve_device


def _world() -> int:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("no process group is initialised: call "
                           "torch.distributed.init_process_group first")
    return dist.get_world_size()


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    """The (16, 16) ("data", "model") mesh, or (2, 16, 16) ("pod", "data",
    "model") with ``multi_pod``, over a process group of 256 or 512 ranks
    (the dry run's is ``"fake"``: ``init_process_group("fake",
    store=FakeStore(), ...)``)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    ranks = 512 if multi_pod else 256
    if _world() != ranks:
        raise ValueError(f"a mesh of {ranks} ranks over a world of {_world()}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(model: int = 1, device_type: Optional[str] = None) -> DeviceMesh:
    """A ``(world // model, model)`` mesh over the current group (tests,
    CPU runs); ``device_type`` defaults to ``CONFIG.device``'s."""
    world = _world()
    if world % model:
        raise ValueError(f"model axis {model} does not divide a world of {world}")
    dt = device_type or resolve_device(None).type
    return init_device_mesh(dt, (world // model, model), mesh_dim_names=("data", "model"))
