"""Pendulum-v1 (continuous torque control), over a batch dimension.

Counterpart of ``repro/rl/envs/pendulum.py``: the reference's offline
stand-in for the paper's PyBullet continuous-control suite.  Swing a
pendulum up and hold it; the action is a torque in [-2, 2], the
observation ``(cos theta, sin theta, theta_dot)``, the reward minus the
cost ``th**2 + 0.1 theta_dot**2 + 0.001 u**2`` (``th`` the angle wrapped
to [-pi, pi)); a reset draws theta from U(-pi, pi) and theta_dot from
U(-1, 1).  The dynamics are the reference's expressions in the same
order, in float32.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.rl.env import Env, EnvSpec

MAX_SPEED = 8.0
MAX_TORQUE = 2.0
DT = 0.05
G = 10.0
M = 1.0
L = 1.0


class PendulumState(NamedTuple):
    """Batched Pendulum state; every field is ``(B,)``."""

    theta: torch.Tensor
    theta_dot: torch.Tensor
    t: torch.Tensor            # int32


def obs_of(s: PendulumState) -> torch.Tensor:
    """The ``(B, 3)`` observation of a state."""
    return torch.stack([torch.cos(s.theta), torch.sin(s.theta),
                        s.theta_dot], dim=-1)


def make_pendulum(max_steps: int = 200) -> Env:
    """The batched Pendulum env; actions are ``(B, 1)`` torques."""
    spec = EnvSpec("pendulum", obs_shape=(3,), action_dim=1,
                   action_scale=MAX_TORQUE, max_steps=max_steps)

    def reset(generator: torch.Generator, n: int, device=None):
        """Draw ``n`` fresh episodes from ``generator`` onto ``device``
        (``None`` is ``cuda``)."""
        device = resolve_device(device)
        u = torch.rand((n, 2), generator=generator,
                       device=generator.device).to(device)
        s = PendulumState((u[:, 0] * 2.0 - 1.0) * math.pi,
                          u[:, 1] * 2.0 - 1.0,
                          torch.zeros(n, dtype=torch.int32, device=device))
        return s, obs_of(s)

    def step(s: PendulumState, action: torch.Tensor,
             generator: Optional[torch.Generator] = None):
        """One step of every env: ``(state, obs, reward, done)``."""
        u = torch.clamp(action.to(s.theta.device)[..., 0], -MAX_TORQUE,
                        MAX_TORQUE)
        th = ((s.theta + math.pi) % (2 * math.pi)) - math.pi
        cost = th ** 2 + 0.1 * s.theta_dot ** 2 + 0.001 * u ** 2
        theta_dot = s.theta_dot + (3 * G / (2 * L) * torch.sin(s.theta)
                                   + 3.0 / (M * L ** 2) * u) * DT
        theta_dot = torch.clamp(theta_dot, -MAX_SPEED, MAX_SPEED)
        theta = s.theta + theta_dot * DT
        t = s.t + 1
        ns = PendulumState(theta, theta_dot, t)
        done = (t >= max_steps).to(torch.float32)
        return ns, obs_of(ns), -cost, done

    return Env(spec=spec, reset=reset, step=step)
