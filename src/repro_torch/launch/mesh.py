"""Meshes of ranks for the port.

Counterpart of ``repro/launch/mesh.py``'s host mesh.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the initialised default
process group (``torch.distributed.init_process_group``: NCCL on the
card, gloo on the CPU or for ranks that share one card), one rank a
process.  The reference's production pod mesh and its chip constants
have no counterpart yet (ROADMAP queue A, item 14b).
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve_device


def make_host_mesh(model: int = 1, device=None) -> DeviceMesh:
    """A ``(world // model, model)`` mesh with dims ``("data", "model")``
    over every rank of the default group (``model`` capped at the world
    size).  ``device=None`` is ``cuda``."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialised process "
                           "group (torch.distributed.init_process_group)")
    n = dist.get_world_size()
    model = min(model, n)
    if n % model:
        raise ValueError(f"world size {n} must divide by model {model}")
    return init_device_mesh(dev.type, (n // model, model),
                            mesh_dim_names=("data", "model"))


def data_axes(multi_pod: bool):
    """The dims a batch is split over."""
    return ("pod", "data") if multi_pod else ("data",)


def n_chips(multi_pod: bool) -> int:
    """Chips of the reference's production mesh (a pod, or two)."""
    return 512 if multi_pod else 256
