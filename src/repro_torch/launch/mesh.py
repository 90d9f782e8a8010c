"""Meshes on ``torch.distributed`` — ``repro.launch.mesh``.

``make_mesh(shape, axes)`` lays a ``DeviceMesh`` over the first
``prod(shape)`` ranks of the process group, on the card unless the caller
asks for the CPU; like the reference's, it raises when the world has
fewer ranks than the mesh needs.  ``ensure_world`` starts the process
group: from a launcher's environment (``torchrun`` sets ``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``), or else as a world
of one, so that ``--mesh 1x1`` runs alone.  The backend follows the
device: NCCL on the card, gloo on the CPU; nothing swaps one for the
other.  The production meshes keep the reference's shapes, (16, 16) and
(2, 16, 16), and raise on a smaller world.
"""

from __future__ import annotations

import math
import os
import socket

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.device import resolve_device

__all__ = ["make_production_mesh", "make_mesh", "mesh_devices",
           "ensure_world", "production_shape"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def ensure_world(device="cuda") -> None:
    """Start the default process group if none is up: from the launcher's
    environment when ``RANK`` and ``WORLD_SIZE`` are set, else a world of
    one on ``localhost``.  On the card each rank takes the card of its
    ``LOCAL_RANK``."""
    dev = resolve_device(device)
    if dist.is_initialized():
        return
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
        return
    dist.init_process_group(backend, init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)


def make_mesh(shape, axes, device="cuda"):
    """``DeviceMesh`` of ``shape`` named ``axes`` over the first
    ``prod(shape)`` ranks (every rank of the world: ``init_device_mesh``
    lays the mesh over the whole group)."""
    n = math.prod(shape)
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call ensure_world "
                           "or run under torchrun")
    have = dist.get_world_size()
    if have < n:
        raise RuntimeError(f"need {n} ranks, have {have}")
    if have != n:
        raise RuntimeError(f"a mesh of {n} ranks in a world of {have}: "
                           "launch as many ranks as the mesh has")
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=tuple(axes))


def production_shape(multi_pod: bool = False):
    """(shape, axis names) of the production mesh: one pod of 16 x 16, or
    two."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    return make_mesh(*production_shape(multi_pod), device)


def mesh_devices(mesh) -> int:
    return math.prod(tuple(mesh.shape))
