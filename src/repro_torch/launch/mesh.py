"""Device meshes: the counterpart of ``repro.launch.mesh``.

``make_production_mesh`` is a function, not a module constant, so that
importing this module touches no process group: the dry run starts a fake
one of 256 or 512 ranks first (``launch/dryrun.py``).

Single pod:  (16, 16)      dims ("data", "model")         = 256 cards
Multi-pod:   (2, 16, 16)   dims ("pod", "data", "model")  = 512 cards
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist

from ..distributed.sharding import mesh_context


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """``init_device_mesh`` over the production shape.  The world (the
    initialized process group, else this one process) must hold the
    mesh's 256 or 512 ranks: the reference's assertion otherwise."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    have = _world()
    assert have >= n, (
        f"need {n} devices for mesh {shape}, have {have} — the dry-run "
        f"must start a fake process group of {n} ranks")
    if have > n:
        raise ValueError(f"a world of {have} ranks is not a {shape} mesh")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(model_axis: int = 1, device_type: str = "cuda"):
    """The ``(1, 1)`` mesh ``("data", "model")`` over this process's one
    device (``device_type`` "cpu" when the caller runs on the CPU).  With
    no process group it starts a one-rank gloo group on a local store
    (the host mesh runs no collective), which :func:`release_host_mesh`
    destroys."""
    from torch.distributed.device_mesh import DeviceMesh
    if model_axis != 1:
        raise ValueError("the host mesh is (1, 1): one device")
    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
        _OWNED.append(True)
    return DeviceMesh(device_type, torch.zeros((1, 1), dtype=torch.int),
                      mesh_dim_names=("data", "model"))


_OWNED: list = []


def release_host_mesh() -> None:
    """Destroy the process group :func:`make_host_mesh` started, if any."""
    if _OWNED:
        _OWNED.clear()
        dist.destroy_process_group()


@contextlib.contextmanager
def launch_mesh(name: str, device_type: str, fsdp: bool = False,
                seq_shard: bool = False):
    """The launchers' ``--mesh`` (``host``, ``production``, ``multipod``)
    under ``mesh_context`` with their rule flags: ``--seq-shard`` maps
    ``seq`` to ``model``, ``--fsdp`` shards each parameter's ``fsdp_dim``.
    The production meshes need their world; the host mesh is one device,
    on which every rule resolves to a dim of size 1 and the step computes
    what it computes without the flags."""
    if name == "host":
        mesh = make_host_mesh(device_type=device_type)
    else:
        mesh = make_production_mesh(multi_pod=name == "multipod",
                                    device_type=device_type)
    try:
        with mesh_context(mesh, overrides={"seq": "model"} if seq_shard
                          else {}, fsdp=fsdp):
            yield mesh
    finally:
        release_host_mesh()
