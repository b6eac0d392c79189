"""Partially observed env wrappers and the frame-stacking adapter.

Counterpart of ``repro/rl/envs/wrappers.py``, over a batch dimension.

* ``make_masked_catch`` -- Catch with the ball pixel visible only in the
  top ``visible_rows`` rows: the policy must remember the ball's column.
* ``make_flicker_airnav`` -- AirNav with the observation blanked except
  every ``reveal_every``-th step.
* ``make_framestack`` -- stacks the last ``context`` flattened
  observations as rows ``[obs..., t / max_steps, 1.0]``, oldest first;
  rows older than the episode are all zero, so the trailing flag is the
  attention mask of ``models.seq_policy``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.rl.env import Env, EnvSpec
from repro_torch.rl.envs.airnav import make_airnav
from repro_torch.rl.envs.catch import make_catch


def make_masked_catch(grid: int = 5, balls: int = 1,
                      visible_rows: int = 2) -> Env:
    """Catch whose ball pixel (1.0) is hidden below ``visible_rows``; the
    paddle pixel (0.5) stays visible."""
    inner = make_catch(grid=grid, balls=balls)
    spec = EnvSpec("catch_masked", obs_shape=inner.spec.obs_shape,
                   n_actions=inner.spec.n_actions,
                   max_steps=inner.spec.max_steps)

    def mask_obs(obs):
        rows = torch.arange(grid, device=obs.device)[:, None, None]
        return torch.where((rows >= visible_rows) & (obs == 1.0), 0.0, obs)

    def reset(generator, n, device=None):
        """Reset the inner Catch envs, ball hidden below the top rows."""
        state, obs = inner.reset(generator, n, device)
        return state, mask_obs(obs)

    def step(state, action, generator):
        """Step the inner Catch envs, ball hidden below the top rows."""
        state, obs, reward, done = inner.step(state, action, generator)
        return state, mask_obs(obs), reward, done

    return Env(spec=spec, reset=reset, step=step)


class FlickerState(NamedTuple):
    """The wrapped env's state plus the flicker phase ``tick`` (B,)."""

    inner: object
    tick: torch.Tensor


def make_flicker_airnav(reveal_every: int = 3, **kwargs) -> Env:
    """AirNav whose observation is zeroed except every
    ``reveal_every``-th step (the reset observation is always shown)."""
    inner = make_airnav(**kwargs)
    spec = EnvSpec("airnav_flicker", obs_shape=inner.spec.obs_shape,
                   n_actions=inner.spec.n_actions,
                   max_steps=inner.spec.max_steps)

    def reset(generator, n, device=None):
        """Reset the inner AirNav envs at phase 0."""
        state, obs = inner.reset(generator, n, device)
        tick = torch.zeros(n, dtype=torch.int32, device=obs.device)
        return FlickerState(state, tick), obs

    def step(state, action, generator=None):
        """Step the inner AirNav envs; blank the observation off-phase."""
        s, obs, reward, done = inner.step(state.inner, action, generator)
        tick = state.tick + 1
        shown = (tick % reveal_every == 0)[:, None]
        obs = torch.where(shown, obs, torch.zeros_like(obs))
        return FlickerState(s, tick), obs, reward, done

    return Env(spec=spec, reset=reset, step=step)


class FrameStackState(NamedTuple):
    """Inner env state, the frame rows ``(B, context, feat)`` (oldest
    first) and the step index ``t`` (B,)."""

    inner: object
    frames: torch.Tensor
    t: torch.Tensor


def make_framestack(env: Env, context: int = 8) -> Env:
    """Stack the last ``context`` observations into ``(context, feat)``.

    Each row is ``[flattened_obs..., t / max_steps, 1.0]``: the step index
    is the shift-stable positional signal and the trailing ``1.0`` the
    validity flag.  The observation is a copy of the frame rows.
    """
    feat = 1
    for d in env.spec.obs_shape:
        feat *= int(d)
    feat += 2
    spec = EnvSpec(f"{env.spec.name}_seq", obs_shape=(context, feat),
                   n_actions=env.spec.n_actions,
                   action_dim=env.spec.action_dim,
                   action_scale=env.spec.action_scale,
                   max_steps=env.spec.max_steps)
    inv_t = 1.0 / float(env.spec.max_steps)

    def frame_of(obs, t):
        n = obs.shape[0]
        return torch.cat([obs.reshape(n, -1).to(torch.float32),
                          (t.to(torch.float32) * inv_t)[:, None],
                          torch.ones((n, 1), device=obs.device)], dim=-1)

    def reset(generator, n, device=None):
        """Reset the inner envs; only the newest row is filled."""
        state, obs = env.reset(generator, n, device)
        t = torch.zeros(n, dtype=torch.int32, device=obs.device)
        frames = torch.zeros((n, context, feat), device=obs.device)
        frames[:, -1] = frame_of(obs, t)
        return FrameStackState(state, frames, t), frames.clone()

    def step(state, action, generator=None):
        """Step the inner envs and shift the new row in."""
        s, obs, reward, done = env.step(state.inner, action, generator)
        t = state.t + 1
        frames = torch.cat([state.frames[:, 1:], frame_of(obs, t)[:, None]],
                           dim=1)
        return FrameStackState(s, frames, t), frames.clone(), reward, done

    return Env(spec=spec, reset=reset, step=step)


def make_catch_seq(grid: int = 5, balls: int = 1, visible_rows: int = 2,
                   context: int = 6) -> Env:
    """Frame-stacked masked Catch (the sequence-policy training env)."""
    return make_framestack(
        make_masked_catch(grid=grid, balls=balls,
                          visible_rows=visible_rows), context=context)


def make_airnav_seq(reveal_every: int = 3, context: int = 8,
                    max_steps: int = 120) -> Env:
    """Frame-stacked flickering AirNav (the sequence-policy variant)."""
    return make_framestack(
        make_flicker_airnav(reveal_every=reveal_every,
                            max_steps=max_steps), context=context)
