"""Catch -- the pixel-observation Atari proxy, over a batch dimension.

Counterpart of ``repro/rl/envs/catch.py``.  A ball falls from a random
column of a ``grid x grid`` board; the agent moves a paddle (left, stay,
right) on the bottom row; +1 for a catch, -1 for a miss.  Observations
are ``(grid, grid, 1)`` float pixels (ball 1.0, paddle 0.5, the paddle
drawn last).  An episode is ``balls`` consecutive drops; a new ball is
drawn from the step's generator when one reaches the bottom.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.device import resolve_device
from repro_torch.rl.env import Env, EnvSpec


class CatchState(NamedTuple):
    """Batched Catch state; every field is ``(B,)``."""

    ball_x: torch.Tensor      # int32
    ball_y: torch.Tensor      # int32
    paddle_x: torch.Tensor    # int32
    caught: torch.Tensor      # f32 running score of the episode
    balls_left: torch.Tensor  # int32
    t: torch.Tensor           # int32


def make_catch(grid: int = 10, balls: int = 5) -> Env:
    """The batched Catch env (see the module docstring)."""
    spec = EnvSpec("catch", obs_shape=(grid, grid, 1), n_actions=3,
                   max_steps=grid * balls + 2)

    def obs_of(s: CatchState) -> torch.Tensor:
        n = s.ball_x.shape[0]
        rows = torch.arange(n, device=s.ball_x.device)
        board = torch.zeros((n, grid, grid), device=s.ball_x.device)
        board[rows, s.ball_y.long(), s.ball_x.long()] = 1.0
        board[rows, grid - 1, s.paddle_x.long()] = 0.5
        return board[..., None]

    def new_ball(generator: torch.Generator, n: int, device):
        return torch.randint(0, grid, (n,), generator=generator,
                             device=generator.device,
                             dtype=torch.int32).to(device)

    def reset(generator: torch.Generator, n: int, device=None):
        """Draw ``n`` fresh episodes from ``generator`` onto ``device``
        (``None`` is ``cuda``)."""
        device = resolve_device(device)
        ball_x = new_ball(generator, n, device)
        paddle_x = new_ball(generator, n, device)
        zeros = torch.zeros(n, dtype=torch.int32, device=device)
        s = CatchState(ball_x=ball_x, ball_y=zeros, paddle_x=paddle_x,
                       caught=torch.zeros(n, device=device),
                       balls_left=torch.full((n,), balls, dtype=torch.int32,
                                             device=device),
                       t=zeros)
        return s, obs_of(s)

    def step(s: CatchState, action: torch.Tensor,
             generator: torch.Generator):
        """One step of every env: ``(state, obs, reward, done)``; a ball
        that reaches the bottom respawns at a column drawn from
        ``generator``."""
        device = s.ball_x.device
        action = action.to(device=device, dtype=torch.int32)
        paddle = torch.clamp(s.paddle_x + action - 1, 0, grid - 1)
        ball_y = s.ball_y + 1
        at_bottom = ball_y >= grid - 1
        hit = at_bottom & (s.ball_x == paddle)
        reward = torch.where(at_bottom, torch.where(hit, 1.0, -1.0), 0.0)
        balls_left = s.balls_left - at_bottom.to(torch.int32)
        ball_x = torch.where(at_bottom, new_ball(generator, len(at_bottom),
                                                 device), s.ball_x)
        ball_y = torch.where(at_bottom, 0, ball_y).to(torch.int32)
        t = s.t + 1
        ns = CatchState(ball_x, ball_y, paddle.to(torch.int32),
                        s.caught + reward, balls_left, t)
        done = ((balls_left <= 0) | (t >= spec.max_steps)).to(torch.float32)
        return ns, obs_of(ns), reward, done

    return Env(spec=spec, reset=reset, step=step)
