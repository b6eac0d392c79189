"""Host -> device batching over a mesh's data axes.

Counterpart of ``repro/data/pipeline.py``.  The reference places a host
batch on its mesh with the batch dim sharded over the data axes, one
controller for all devices; the port runs one process a rank, so each
rank takes its own slice of the batch dim, as a host of a multi-host pod
feeds its devices their part.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.device import resolve_device


class ShardedBatcher:
    """``put(batch)``: a dict of host arrays to tensors on ``device``
    (``None`` is ``cuda``), each the whole batch without a mesh, or this
    rank's slice of its leading (batch) dim over the mesh's ``"data"``
    dim, which must divide it; with ``multi_pod`` over ``("pod",
    "data")`` jointly, as the reference's one spec entry splits it (the
    pod major).  Called on an iterator of batches, it yields them put."""

    def __init__(self, mesh=None, device=None, multi_pod: bool = False):
        self.mesh = mesh
        self.device = resolve_device(device)
        self.axes = ("pod", "data") if multi_pod else ("data",)

    def _slice(self) -> tuple:
        """(this rank's index over the data dims, their joint size)."""
        index, size = 0, 1
        for name in self.axes:
            n = self.mesh.size(self.mesh.mesh_dim_names.index(name))
            index, size = index * n + self.mesh.get_local_rank(name), \
                size * n
        return index, size

    def put(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(np.asarray(v))
            if self.mesh is not None:
                index, size = self._slice()
                if t.shape[0] % size:
                    raise ValueError(f"batch dim {t.shape[0]} of {k!r} "
                                     f"must divide by the data axes' size "
                                     f"{size}")
                rows = t.shape[0] // size
                t = t[index * rows:(index + 1) * rows]
            out[k] = t.to(self.device)
        return out

    def __call__(self, it: Iterator[Dict[str, np.ndarray]]
                 ) -> Iterator[Dict[str, torch.Tensor]]:
        for batch in it:
            yield self.put(batch)
