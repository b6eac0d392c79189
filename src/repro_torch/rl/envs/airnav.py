"""AirNav -- Air-Learning-style point-to-point aerial navigation (paper 5/D).

Counterpart of ``repro/rl/envs/airnav.py:48-106``, over a batch dimension.
A 2-D point-mass drone crosses a 25 m x 25 m arena with 1-5 random
circular obstacles to a random goal; 25 discrete actions (5 speeds x 5
yaw rates, V_max = 2.5 m/s); reward (paper Eq. 1)

    r = 1000 * alpha - 100 * beta - D_g - D_c * delta - 1

with alpha = reached goal, beta = collision or timeout, D_g the distance
to the goal and D_c = (V_max - V_now) * t_max.  Observation (9 floats):
goal offset, velocity, heading sin/cos, nearest active obstacle offset and
its distance, each scaled as in the reference.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.device import resolve_device
from repro_torch.rl.env import Env, EnvSpec

ARENA = 25.0
V_MAX = 2.5
T_MAX = 0.5           # actuation duration (s)
N_OBSTACLES = 5
OBSTACLE_R = 1.5
GOAL_R = 1.0
DELTA = 1.0           # distance-correction weight
N_ACTIONS = 25
OBS_DIM = 9


class AirNavState(NamedTuple):
    """Batched env state; every field has a leading batch dimension B."""

    pos: torch.Tensor        # (B, 2)
    vel: torch.Tensor        # (B, 2)
    heading: torch.Tensor    # (B,) rad
    goal: torch.Tensor       # (B, 2)
    obstacles: torch.Tensor  # (B, N_OBSTACLES, 3): x, y, active
    t: torch.Tensor          # (B,) int32


def _speeds_yaws(device):
    speeds = torch.linspace(0.0, V_MAX, 5, device=device)
    yaws = torch.linspace(-math.pi / 4, math.pi / 4, 5, device=device)
    return speeds, yaws


def obs_of(s: AirNavState) -> torch.Tensor:
    """The (B, 9) observation of a state."""
    to_goal = s.goal - s.pos
    d_obs = torch.linalg.vector_norm(s.obstacles[..., :2] - s.pos[:, None],
                                     dim=-1)
    d_obs = torch.where(s.obstacles[..., 2] > 0, d_obs,
                        torch.full_like(d_obs, 1e6))
    i = torch.argmin(d_obs, dim=-1, keepdim=True)                  # (B, 1)
    nearest = torch.gather(s.obstacles[..., :2], 1,
                           i[..., None].expand(-1, 1, 2))[:, 0] - s.pos
    d_near = torch.clamp(torch.gather(d_obs, 1, i), max=ARENA)    # (B, 1)
    return torch.cat([to_goal / ARENA, s.vel / V_MAX,
                      torch.stack([torch.sin(s.heading),
                                   torch.cos(s.heading)], dim=-1),
                      nearest / ARENA, d_near / ARENA], dim=-1)


def make_airnav(max_steps: int = 300) -> Env:
    """The batched AirNav env (see the module docstring)."""
    spec = EnvSpec("airnav", obs_shape=(OBS_DIM,), n_actions=N_ACTIONS,
                   max_steps=max_steps)

    def reset(generator: torch.Generator, n: int, device=None):
        """Draw ``n`` fresh episodes from ``generator``, on its device,
        onto ``device`` (``None`` is ``cuda``)."""
        device = resolve_device(device)
        gdev = generator.device

        def uniform(shape, lo, hi):
            return lo + (hi - lo) * torch.rand(shape, generator=generator,
                                               device=gdev)

        pos = uniform((n, 2), 2.0, ARENA - 2.0)
        goal = uniform((n, 2), 2.0, ARENA - 2.0)
        n_active = torch.randint(1, N_OBSTACLES + 1, (n, 1),
                                 generator=generator, device=gdev)
        obs_xy = uniform((n, N_OBSTACLES, 2), 3.0, ARENA - 3.0)
        heading = uniform((n,), -math.pi, math.pi)
        # keep obstacles away from the start position
        d_start = torch.linalg.vector_norm(obs_xy - pos[:, None], dim=-1)
        obs_xy = torch.where((d_start < 3.0)[..., None], obs_xy + 4.0,
                             obs_xy)
        active = (torch.arange(N_OBSTACLES, device=gdev)[None]
                  < n_active).float()
        s = AirNavState(pos=pos, vel=torch.zeros(n, 2, device=gdev),
                        heading=heading, goal=goal,
                        obstacles=torch.cat([obs_xy, active[..., None]], -1),
                        t=torch.zeros(n, dtype=torch.int32, device=gdev))
        s = AirNavState(*(t.to(device) for t in s))
        return s, obs_of(s)

    def step(s: AirNavState, action: torch.Tensor, generator=None):
        """One step of every env: ``(state, obs, reward, done)``.  AirNav
        draws nothing in a step, so ``generator`` is not used."""
        speeds, yaws = _speeds_yaws(s.pos.device)
        action = action.to(device=s.pos.device, dtype=torch.long)
        speed = speeds[action // 5]
        heading = s.heading + yaws[action % 5]
        vel = speed[:, None] * torch.stack([torch.cos(heading),
                                            torch.sin(heading)], dim=-1)
        pos = torch.clamp(s.pos + vel * T_MAX, 0.0, ARENA)
        t = s.t + 1
        d_goal = torch.linalg.vector_norm(s.goal - pos, dim=-1)
        d_obs = torch.linalg.vector_norm(s.obstacles[..., :2] - pos[:, None],
                                         dim=-1)
        collided = ((d_obs < OBSTACLE_R) & (s.obstacles[..., 2] > 0)).any(-1)
        reached = d_goal < GOAL_R
        timeout = t >= max_steps
        alpha = reached.float()
        beta = (collided | timeout).float()
        d_c = (V_MAX - speed) * T_MAX          # paper Eq. 2
        reward = 1000.0 * alpha - 100.0 * beta - d_goal - d_c * DELTA - 1.0
        ns = AirNavState(pos, vel, heading, s.goal, s.obstacles, t)
        return ns, obs_of(ns), reward, torch.maximum(alpha, beta)

    return Env(spec=spec, reset=reset, step=step)
