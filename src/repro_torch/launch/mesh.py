"""Device meshes — the port of ``repro.launch.mesh`` on
``torch.distributed``.

Functions, not module-level constants: importing this module touches no
device or process-group state.  Both build a
:class:`~torch.distributed.device_mesh.DeviceMesh` over the ranks of the
default process group, which the caller initialises (address, world size
and rank are the caller's: nothing here discovers a cluster).
"""
from __future__ import annotations

import math

__all__ = ["make_production_mesh", "make_local_mesh", "init_group"]


def _world() -> int:
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("no process group: call torch.distributed."
                           "init_process_group first")
    return dist.get_world_size()


def _mesh(device_type: str, shape, names):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16×16 ranks ("data", "model"); two pods add a leading "pod" dim,
    (2, 16, 16).  Raises unless the world has 256 (512) ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = _world()
    if world != math.prod(shape):
        raise ValueError(f"make_production_mesh(multi_pod={multi_pod}) "
                         f"needs {math.prod(shape)} ranks for the mesh "
                         f"{shape}; the world has {world}")
    return _mesh(device_type, shape, names)


def make_local_mesh(model: int = 1, device_type: str = "cuda"):
    """Whatever ranks exist, as (world // model, model) over ("data",
    "model") — for tests and the smoke run."""
    world = _world()
    if model < 1 or world % model:
        raise ValueError(f"make_local_mesh: model={model} does not divide "
                         f"the world of {world} ranks")
    return _mesh(device_type, (world // model, model), ("data", "model"))


def init_group(rank: int, world: int, init_method: str,
               backend: str = "nccl") -> None:
    """Join ``rank`` of ``world`` to the default process group at
    ``init_method`` (``file://...`` or ``tcp://localhost:<port>``).  An
    NCCL rank takes card ``rank`` first (NCCL refuses two ranks on one
    card)."""
    import torch
    import torch.distributed as dist
    kw = {}
    if backend == "nccl":
        torch.cuda.set_device(rank)
        kw["device_id"] = torch.device("cuda", rank)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world, **kw)
