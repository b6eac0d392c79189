"""MountainCar-v0 (discrete) and MountainCarContinuous-v0 (Moore 1990),
over a batch dimension.

Counterpart of ``repro/rl/envs/mountaincar.py``.  A car in a valley must
rock itself up to the goal at ``x >= 0.5``.  The observation is ``(pos,
vel)``; a reset draws ``pos`` from U(-0.6, -0.4) with ``vel`` 0.  The
discrete env pushes left, not at all or right (reward -1 a step); the
continuous one takes a force in [-1, 1] (reward 100 at the goal, minus
0.1 force squared a step).  The dynamics are the reference's expressions
in the same order, in float32.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.rl.env import Env, EnvSpec

MIN_POS, MAX_POS = -1.2, 0.6
MAX_SPEED = 0.07
GOAL_POS = 0.5


class MCState(NamedTuple):
    """Batched MountainCar state; every field is ``(B,)``."""

    pos: torch.Tensor
    vel: torch.Tensor
    t: torch.Tensor            # int32


def obs_of(s: MCState) -> torch.Tensor:
    """The ``(B, 2)`` observation of a state."""
    return torch.stack([s.pos, s.vel], dim=-1)


def _reset(generator: torch.Generator, n: int, device=None):
    """Draw ``n`` fresh episodes from ``generator`` onto ``device``
    (``None`` is ``cuda``)."""
    device = resolve_device(device)
    u = torch.rand((n,), generator=generator, device=generator.device)
    pos = (u * 0.2 - 0.6).to(device)
    s = MCState(pos, torch.zeros(n, device=device),
                torch.zeros(n, dtype=torch.int32, device=device))
    return s, obs_of(s)


def _move(s: MCState, push: torch.Tensor, max_steps: int):
    """The shared dynamics after the push: ``(state, reached, done)``."""
    vel = torch.clamp(s.vel + push + torch.cos(3 * s.pos) * (-0.0025),
                      -MAX_SPEED, MAX_SPEED)
    pos = torch.clamp(s.pos + vel, MIN_POS, MAX_POS)
    vel = torch.where((pos == MIN_POS) & (vel < 0), 0.0, vel)
    t = s.t + 1
    reached = pos >= GOAL_POS
    done = (reached | (t >= max_steps)).to(torch.float32)
    return MCState(pos, vel, t), reached, done


def make_mountaincar(max_steps: int = 200) -> Env:
    """The batched discrete MountainCar env (3 actions)."""
    spec = EnvSpec("mountaincar", obs_shape=(2,), n_actions=3,
                   max_steps=max_steps)

    def step(s: MCState, action: torch.Tensor,
             generator: Optional[torch.Generator] = None):
        """One step of every env: ``(state, obs, reward, done)``."""
        force = (action.to(device=s.pos.device, dtype=torch.float32)
                 - 1.0) * 0.001
        ns, _, done = _move(s, force, max_steps)
        return ns, obs_of(ns), -torch.ones_like(ns.pos), done

    return Env(spec=spec, reset=_reset, step=step)


def make_mountaincar_continuous(max_steps: int = 999) -> Env:
    """The batched continuous MountainCar env (the paper's DDPG entry);
    actions are ``(B, 1)`` forces."""
    spec = EnvSpec("mountaincar_continuous", obs_shape=(2,), action_dim=1,
                   max_steps=max_steps)

    def step(s: MCState, action: torch.Tensor,
             generator: Optional[torch.Generator] = None):
        """One step of every env: ``(state, obs, reward, done)``."""
        force = torch.clamp(action.to(s.pos.device)[..., 0], -1.0, 1.0)
        ns, reached, done = _move(s, force * 0.0015, max_steps)
        reward = torch.where(reached, 100.0, 0.0) - 0.1 * force ** 2
        return ns, obs_of(ns), reward, done

    return Env(spec=spec, reset=_reset, step=step)
