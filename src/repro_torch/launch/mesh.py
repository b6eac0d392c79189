"""Meshes of ranks for the port.

Counterpart of ``repro/launch/mesh.py``'s host mesh.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the initialised default
process group (``torch.distributed.init_process_group``: NCCL on the
card, gloo on the CPU or for ranks that share one card), one rank a
process.  ``make_production_mesh`` is the reference's pod mesh, 16 x 16
(``("data", "model")``) or 2 x 16 x 16 (``("pod", "data", "model")``),
over a default group of 256 or 512 ranks: for the pod dry-run a fake
group in one process (``init_fake_group``), the counterpart of the
reference's 512 forced host devices.

The card's constants (NVIDIA H100 80GB HBM3, power limit 700.00 W, the
card the port is measured on) replace the reference's TPU v5e ones;
no TPU number is used.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve_device

# NVIDIA H100 80GB HBM3 (SXM), per card, dense: the rates PERF.md's bounds use
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
HBM_BW = 3.35e12                # bytes/s
PEAK_OPS_INT8 = 1979e12         # int8 tensor-core op/s
PEAK_FLOPS_BF16 = 989e12        # bf16 tensor-core FLOP/s
NVLINK_BW = 450e9               # bytes/s each way (NVLink 4, 18 links)


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


def folded(mesh: DeviceMesh) -> DeviceMesh:
    """``mesh`` with its ``pod`` and ``data`` dims folded into one
    ``data`` dim, pod major (the 2-pod mesh as 32 x 16), the same ranks
    in the same order; a mesh without ``pod`` as it is.  The reference's
    joint split ``("pod", "data")`` is then one split, the same shards
    (``ceil(ceil(n / 2) / 16) == ceil(n / 32)``): DTensor plans
    redistributions of a dim split over two mesh dims by a min-cost
    search that takes minutes a layer.  A constraint naming ``data``
    alone then splits 32 ways where the reference's splits 16 and keeps
    the pods whole (ROADMAP queue C)."""
    import torch
    names = mesh.mesh_dim_names
    if "pod" not in names:
        return mesh
    shape = dict(zip(names, mesh.mesh.shape))
    ranks = mesh.mesh.reshape(shape["pod"] * shape["data"], shape["model"])
    return DeviceMesh(mesh.device_type, torch.as_tensor(ranks),
                      mesh_dim_names=("data", "model"))


def data_axes(multi_pod: bool):
    """The dims a batch is split over."""
    return ("pod", "data") if multi_pod else ("data",)


def n_chips(multi_pod: bool) -> int:
    """Chips of the reference's production mesh (a pod, or two)."""
    return 512 if multi_pod else 256


def init_fake_group(world: int) -> None:
    """A fake default process group of ``world`` ranks in this process
    (this process is rank 0): collectives return at once, moving nothing.
    Destroy it with ``torch.distributed.destroy_process_group``."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def make_production_mesh(multi_pod: bool = False, device=None) -> DeviceMesh:
    """The reference's production mesh over the default group, which
    must hold 256 ranks (512 with ``multi_pod``).  ``device=None`` is
    ``cuda``."""
    import torch
    dev = resolve_device(device)
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    if not dist.is_initialized() or dist.get_world_size() != n_chips(
            multi_pod):
        raise RuntimeError(f"the production mesh needs a default group of "
                           f"{n_chips(multi_pod)} ranks")
    return DeviceMesh(dev.type, torch.arange(n_chips(multi_pod)).reshape(
        shape), mesh_dim_names=names)
