"""CartPole-v1 (gym's dynamics; Barto, Sutton & Anderson 1983), over a
batch dimension.

Counterpart of ``repro/rl/envs/cartpole.py:31-73``.  A pole on a cart;
two actions push the cart left or right with 10 N; +1 reward per step;
an episode ends when the cart leaves +-2.4 m, the pole tilts past 12
degrees, or after ``max_steps`` steps.  The observation is ``(x, x_dot,
theta, theta_dot)``; a reset draws each from U(-0.05, 0.05).  The
dynamics are the reference's expressions in the same order, in float32.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.rl.env import Env, EnvSpec

GRAVITY = 9.8
MASSCART = 1.0
MASSPOLE = 0.1
TOTAL_MASS = MASSCART + MASSPOLE
LENGTH = 0.5
POLEMASS_LENGTH = MASSPOLE * LENGTH
FORCE_MAG = 10.0
TAU = 0.02
THETA_THRESHOLD = 12 * 2 * math.pi / 360
X_THRESHOLD = 2.4


class CartPoleState(NamedTuple):
    """Batched CartPole state; every field is ``(B,)``."""

    x: torch.Tensor
    x_dot: torch.Tensor
    theta: torch.Tensor
    theta_dot: torch.Tensor
    t: torch.Tensor            # int32


def obs_of(s: CartPoleState) -> torch.Tensor:
    """The ``(B, 4)`` observation of a state."""
    return torch.stack([s.x, s.x_dot, s.theta, s.theta_dot], dim=-1)


def make_cartpole(max_steps: int = 500) -> Env:
    """The batched CartPole env (see the module docstring)."""
    spec = EnvSpec("cartpole", obs_shape=(4,), n_actions=2,
                   max_steps=max_steps)

    def reset(generator: torch.Generator, n: int, device=None):
        """Draw ``n`` fresh episodes from ``generator`` onto ``device``
        (``None`` is ``cuda``)."""
        device = resolve_device(device)
        u = torch.rand((n, 4), generator=generator, device=generator.device)
        vals = (u * 0.1 - 0.05).to(device)
        s = CartPoleState(vals[:, 0], vals[:, 1], vals[:, 2], vals[:, 3],
                          torch.zeros(n, dtype=torch.int32, device=device))
        return s, obs_of(s)

    def step(s: CartPoleState, action: torch.Tensor,
             generator: Optional[torch.Generator] = None):
        """One step of every env: ``(state, obs, reward, done)``."""
        action = action.to(s.x.device)
        force = torch.where(action == 1, FORCE_MAG, -FORCE_MAG).to(
            torch.float32)
        costheta, sintheta = torch.cos(s.theta), torch.sin(s.theta)
        temp = (force + POLEMASS_LENGTH * s.theta_dot ** 2 * sintheta) \
            / TOTAL_MASS
        thetaacc = (GRAVITY * sintheta - costheta * temp) / (
            LENGTH * (4.0 / 3.0 - MASSPOLE * costheta ** 2 / TOTAL_MASS))
        xacc = temp - POLEMASS_LENGTH * thetaacc * costheta / TOTAL_MASS
        x = s.x + TAU * s.x_dot
        x_dot = s.x_dot + TAU * xacc
        theta = s.theta + TAU * s.theta_dot
        theta_dot = s.theta_dot + TAU * thetaacc
        t = s.t + 1
        ns = CartPoleState(x, x_dot, theta, theta_dot, t)
        done = ((torch.abs(x) > X_THRESHOLD)
                | (torch.abs(theta) > THETA_THRESHOLD)
                | (t >= max_steps)).to(torch.float32)
        return ns, obs_of(ns), torch.ones_like(x), done

    return Env(spec=spec, reset=reset, step=step)
