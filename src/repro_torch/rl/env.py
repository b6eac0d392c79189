"""Environment API of the port (subset: spec, env, batched env).

Counterpart of ``repro/rl/env.py:27-46, 115-123``.  Where the reference
vmaps a single-env function, the port's envs are written over a leading
batch dimension:

    env.reset(generator, n, device) -> (state, obs)          # n envs
    env.step(state, action)         -> (state, obs, reward, done)

Random draws come from an explicit ``torch.Generator`` (on the CPU, so one
seed gives the same envs on every device); the draws are then moved to
``device``, which is ``cuda`` when it is ``None``
(``repro_torch.device``).  Observations are f32, discrete actions integer.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class EnvSpec:
    """Static description of an env: obs shape, action space, horizon."""

    name: str
    obs_shape: Tuple[int, ...]
    n_actions: int = 0            # discrete envs
    action_dim: int = 0           # continuous envs
    action_scale: float = 1.0     # actor outputs [-1, 1] * action_scale
    max_steps: int = 500

    @property
    def continuous(self) -> bool:
        """True for a continuous action space."""
        return self.action_dim > 0


class Env(NamedTuple):
    """An env over a leading batch dimension (see the module docstring)."""

    spec: EnvSpec
    reset: Callable[..., Tuple[Any, torch.Tensor]]
    step: Callable[..., Tuple[Any, torch.Tensor, torch.Tensor, torch.Tensor]]


def batched_env(env: Env, n: int) -> Env:
    """``env`` with its batch size fixed to ``n``.

    The returned ``reset`` takes ``(generator, device=None)``, ``None``
    being ``cuda``; ``step`` is the env's own, which already maps over the
    batch dimension.
    """
    def reset(generator: torch.Generator, device=None):
        """Reset ``n`` envs from ``generator``."""
        return env.reset(generator, n, device)

    return Env(spec=env.spec, reset=reset, step=env.step)
