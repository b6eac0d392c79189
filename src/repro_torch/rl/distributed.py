"""Data-parallel RL across ``torch.distributed`` ranks: the mesh axis
helpers of the actor-learner topologies, and synchronous A2C over a
``"data"`` axis.

Counterpart of ``repro/rl/distributed.py``.  The reference runs one
controller over many devices and ``shard_map``s the actor (or data) axis;
the port runs SPMD, one process a rank, each calling the same entry
point.  A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with
named dims, built over the initialised default process group (NCCL on
the card; gloo on the CPU, and gloo on CUDA tensors for ranks that share
one card).  ``Axis`` is one named dim of it as a rank's code sees it:

==========================================  ================================
reference (``shard_map`` body)              port (each rank)
==========================================  ================================
``P(axis)`` leaves (replay shards, env       the rank's own slice
rows, divergence)
``P()`` leaves (params, opt state,           a full copy a rank, bitwise
observers, actor params, cache)              equal across ranks
``jax.lax.pmean(tree, axis)``                ``Axis.mean``: one ``all_reduce``
                                             (sum) of every floating leaf
                                             flattened into one buffer, then
                                             ``/ size``
``jax.lax.psum(total_size, axis)``           ``Axis.sum``: ``all_reduce`` of
                                             an int64
``all_gather(x, axis, axis=0, tiled=True)``  ``Axis.gather``: the list form of
                                             ``all_gather`` in rank order,
                                             then ``torch.cat``
``axis_index(axis)``                         ``Axis.index``
``fold_in(key, axis_index)``                 ``rank_generator``
==========================================  ================================

Without a mesh (``Axis(None, ...)``) every method is the identity and
issues nothing.  A world-1 mesh is bitwise the no-mesh run: the sum of
one value divided by 1 is the value, and rank 0 draws from the caller's
generator (``rank_generator``).

Gloo's collectives take CPU tensors, so with gloo a CUDA tensor goes
through a host copy (which waits for the card).  Every collective adds
one to ``stats.calls`` and its host time (the call's wall time on the
host: with NCCL the enqueue, with gloo the whole exchange) to
``stats.host_s``; ``Axis.mean``'s flattening into one buffer and its
slicing back add their host time to ``stats.pack_s``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.core.ptq import tree_flatten, tree_unflatten
from repro_torch.rl import a2c
from repro_torch.rl.env import Env
from repro_torch.rl.networks import Network

# rank r > 0 seeds its generators ``initial_seed + r * RANK_SEED_STRIDE``
# (mod 2**63): far apart for any seed a run takes, and rank 0 keeps the
# caller's generator as it is
RANK_SEED_STRIDE = 0x9E3779B97F4A7C15


@dataclasses.dataclass
class CollectiveStats:
    """Collectives issued by this process, their host seconds, and the
    host seconds of ``Axis.mean``'s packing around them."""

    calls: int = 0
    host_s: float = 0.0
    pack_s: float = 0.0

    def reset(self) -> None:
        self.calls, self.host_s, self.pack_s = 0, 0.0, 0.0


stats = CollectiveStats()
# a process group -> its twin over the same ranks (``Axis.split``), made
# once: a new NCCL group builds a communicator at its first collective
_twins: dict = {}


def rank_generator(generator: torch.Generator,
                   index: int) -> torch.Generator:
    """Rank ``index``'s generator of a stream: rank 0's is ``generator``
    itself; rank r > 0's a new generator on its device seeded
    ``(generator.initial_seed() + r * RANK_SEED_STRIDE) mod 2**63``."""
    if index == 0:
        return generator
    seed = (generator.initial_seed() + index * RANK_SEED_STRIDE) % (1 << 63)
    return torch.Generator(device=generator.device).manual_seed(seed)


class Axis:
    """One named dim of a ``DeviceMesh``, or no mesh (``mesh=None``: size
    1, index 0, and every collective the identity).

    ``group`` (optional) issues the collectives on another process group
    over the same ranks: the async actors use their own, so their
    collectives never queue behind the learner's (NCCL runs a group's
    collectives in issue order on one stream)."""

    def __init__(self, mesh, name: str, group=None):
        self.mesh, self.name = mesh, name
        if mesh is None:
            self.group, self.size, self.index = None, 1, 0
            return
        if name not in (mesh.mesh_dim_names or ()):
            raise ValueError(f"the mesh has no {name!r} dim (its dims are "
                             f"{mesh.mesh_dim_names})")
        self.group = group if group is not None else mesh.get_group(name)
        self.size = dist.get_world_size(self.group)
        self.index = mesh.get_local_rank(name)

    def split(self) -> "Axis":
        """The same axis on a second process group over the same ranks,
        made by the first call for this axis's group (on every rank, in
        the same order, as ``dist.new_group`` asks) and reused after."""
        if self.mesh is None:
            return self
        if self.group not in _twins:
            _twins[self.group] = dist.new_group(
                dist.get_process_group_ranks(self.group))
        return Axis(self.mesh, self.name, _twins[self.group])

    def _on_host(self, x: torch.Tensor) -> bool:
        """Gloo's collectives take CPU tensors: a CUDA tensor on gloo (ranks
        that share one card) goes through the host."""
        return x.is_cuda and dist.get_backend(self.group) == "gloo"

    def _collect(self, fn, x: torch.Tensor) -> torch.Tensor:
        """``fn(x)`` (a collective filling ``x`` in place, or returning its
        result), on a host copy where ``_on_host``; counted and timed."""
        t = time.perf_counter()
        host = self._on_host(x)
        out = fn(x.cpu() if host else x)
        out = out.to(x.device) if host else out
        stats.calls += 1
        stats.host_s += time.perf_counter() - t
        return out

    def _all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(x, group=self.group)
        return x

    def mean(self, tree: Any) -> Any:
        """``pmean``: every floating leaf of ``tree`` averaged over the
        axis through one ``all_reduce`` of one flattened buffer; other
        leaves (an observer's ``initialized`` flag, the same on every
        rank) pass through."""
        if self.mesh is None:
            return tree
        t = time.perf_counter()
        _, leaves = tree_flatten(tree)
        idx = [i for i, x in enumerate(leaves)
               if isinstance(x, torch.Tensor) and x.is_floating_point()]
        if not idx:
            return tree
        with torch.no_grad():
            buf = torch.cat([leaves[i].reshape(-1).to(torch.float32)
                             for i in idx])
        t_collect = stats.host_s
        buf = self._collect(self._all_reduce, buf) / self.size
        out, pos = list(leaves), 0
        for i in idx:
            x = leaves[i]
            out[i] = buf[pos:pos + x.numel()].reshape(x.shape).to(x.dtype)
            pos += x.numel()
        stats.pack_s += time.perf_counter() - t - (stats.host_s - t_collect)
        return tree_unflatten(tree, out)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``psum`` of an integer count, as int64."""
        if self.mesh is None:
            return x
        return self._collect(self._all_reduce, x.to(torch.int64).clone())

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` concatenated on dim 0 in rank order."""
        if self.mesh is None:
            return x

        def all_gather(src):
            parts = [torch.empty_like(src) for _ in range(self.size)]
            dist.all_gather(parts, src.contiguous(), group=self.group)
            return torch.cat(parts)
        return self._collect(all_gather, x)


def make_distributed_a2c(env: Env, net: Network, cfg: a2c.A2CConfig, mesh,
                         axis: str = "data", device=None):
    """``(iteration, act_fn, benv)``: synchronous data-parallel A2C, one
    rank a slice of the ``n_envs`` envs: ``a2c.make_iteration`` on the
    mesh's ``axis``.

    ``iteration(state, env_state, obs, generator)``, ``generator`` the
    rank's own (``rank_generator``), rolls out over the rank's ``n_envs /
    size`` envs (``benv``), through the packed actor when the backend is
    quantized (each rank calibrates on its own observations under
    ``calib_batch``), then takes ``a2c.make_learner``'s step with its
    gradients, loss and observers averaged over the axis in one
    ``all_reduce``; the reward is averaged too.  ``device=None`` is
    ``cuda``.
    """
    return a2c.make_iteration(env, net, cfg, device, ax=Axis(mesh, axis))
