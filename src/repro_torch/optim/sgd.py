"""SGD with optional (Nesterov) momentum, on param trees.

Counterpart of ``repro/optim/sgd.py``: functional, the velocity kept in
float32 and each param updated in float32 and cast back to its dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.ptq import tree_map, tree_tensors

Tree = Any


@dataclasses.dataclass(frozen=True)
class SGDConfig:
    """The learning rate and the momentum (0: plain SGD)."""

    lr: float = 1e-2
    momentum: float = 0.0
    nesterov: bool = False


class SGDState(NamedTuple):
    """Step count (0-d int32) and the velocity (None without momentum)."""

    step: torch.Tensor
    velocity: Optional[Tree]


def sgd_init(params: Tree, config: SGDConfig) -> SGDState:
    """Zero velocity shaped like ``params`` (with momentum), on their
    device."""
    device = next(t for _, t in tree_tensors(params)).device
    vel = None
    if config.momentum:
        vel = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                       params)
    return SGDState(torch.zeros((), dtype=torch.int32, device=device), vel)


def sgd_update(grads: Tree, state: SGDState, params: Tree,
               config: SGDConfig) -> Tuple[Tree, SGDState]:
    """One step: ``(new_params, new_state)``."""
    if config.momentum:
        vel = tree_map(lambda v, g: config.momentum * v
                       + g.to(torch.float32), state.velocity, grads)
        upd = tree_map(lambda v, g: config.momentum * v
                       + g.to(torch.float32), vel, grads) \
            if config.nesterov else vel
        new_params = tree_map(lambda p, u: (p.to(torch.float32)
                                            - config.lr * u).to(p.dtype),
                              params, upd)
        return new_params, SGDState(state.step + 1, vel)
    new_params = tree_map(
        lambda p, g: (p.to(torch.float32)
                      - config.lr * g.to(torch.float32)).to(p.dtype),
        params, grads)
    return new_params, SGDState(state.step + 1, None)
