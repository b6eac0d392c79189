"""Environment API of the port: spec, batched env, auto-reset, rollout,
evaluation.

Counterpart of ``repro/rl/env.py:27-211``.  Where the reference vmaps a
single-env function, the port's envs are written over a leading batch
dimension:

    env.reset(generator, n, device)         -> (state, obs)     # n envs
    env.step(state, action, generator=None) -> (state, obs, reward, done)

Random draws come from an explicit ``torch.Generator`` and are made on
the generator's device (a CPU generator gives the same envs on every
device; a CUDA one keeps a rollout on the card with no host round trip),
then moved to ``device``, which is ``cuda`` when it is ``None``
(``repro_torch.device``).  ``step`` takes the generator for envs that
draw there (Catch respawns its ball); the others ignore it.  Where the
reference splits one key per use, the port draws from one generator in
turn.  Observations are f32, discrete actions integer.

A state is a tree of tensors with a leading batch dimension: nested
``NamedTuple``s, tuples and dicts of them (``core.ptq.tree_map``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.ptq import tree_map
from repro_torch.device import resolve_device


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


class StepOut(NamedTuple):
    """One step of a trajectory; ``rollout`` stacks them over time."""

    obs: torch.Tensor
    action: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    next_obs: torch.Tensor
    logits_or_value: Any = None


class StatefulPolicy(NamedTuple):
    """A rollout policy that carries per-env state (the KV-cache actors).

    ``apply(params, obs, pstate, generator) -> (action, new_pstate,
    aux)``.  Pair it with ``attach_policy_state``, which carries
    ``pstate`` inside the env state, so ``auto_reset_step`` resets it per
    env to its initial value when an episode ends.
    """

    apply: Callable[..., Tuple[torch.Tensor, Any, Any]]


def attach_policy_state(benv: Env, pstate0: Any) -> Env:
    """Wrap a batched env so its state is ``(inner_state, pstate)``.

    ``reset`` returns ``pstate0`` (the all-reset policy state of every
    env, moved to the reset's device) beside the inner reset; ``step``
    passes ``pstate`` through untouched: only ``rollout``'s
    ``StatefulPolicy`` branch writes it.
    """
    def reset(generator: torch.Generator, device=None):
        """Reset the inner envs; the policy state starts at ``pstate0``."""
        device = resolve_device(device)
        state, obs = benv.reset(generator, device)
        return (state, tree_map(lambda t: t.to(device), pstate0)), obs

    def step(state, action, generator: Optional[torch.Generator] = None):
        """Step the inner envs; the policy state rides along."""
        inner, ps = state
        inner, obs, reward, done = benv.step(inner, action, generator)
        return (inner, ps), obs, reward, done

    return Env(spec=benv.spec, reset=reset, step=step)


def _bshape(done: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return done.reshape(done.shape + (1,) * (x.dim() - done.dim()))


def auto_reset_step(env: Env) -> Callable:
    """``step`` of a batched env that resets each env when it is done.

    Every leaf of the state (a policy state from ``attach_policy_state``
    included) and the observation are masked against a fresh reset with
    ``torch.where``, so a finished env starts its next episode in the
    same call.  The reward and ``done`` are the finishing step's.
    """
    def step(state, action, generator: torch.Generator):
        """One step of every env, with per-env reset on done."""
        new_state, obs, reward, done = env.step(state, action, generator)
        reset_state, reset_obs = env.reset(generator, obs.device)
        d = done > 0
        state_out = tree_map(lambda r, n: torch.where(_bshape(d, n), r, n),
                             reset_state, new_state)
        obs_out = torch.where(_bshape(d, obs), reset_obs, obs)
        return state_out, obs_out, reward, done
    return step


def rollout(env: Env, policy_fn, params, state, obs,
            generator: torch.Generator, n_steps: int):
    """Collect ``n_steps`` steps of a batched env, resetting each env
    when it is done (``auto_reset_step``).

    ``policy_fn(params, obs, generator) -> (action, aux)``; ``aux`` (the
    Q-values, logits or mu, or a tuple of tensors) is kept in the
    trajectory, stacked over time.  A
    ``StatefulPolicy`` needs ``env`` wrapped by ``attach_policy_state``:
    it reads and writes the ``pstate`` half of the env state each step.
    Returns ``(final_state, final_obs, traj)``, ``traj`` a ``StepOut`` of
    tensors stacked over a leading time dimension.  Nothing here waits on
    the card.
    """
    stepper = auto_reset_step(env)
    stateful = isinstance(policy_fn, StatefulPolicy)
    outs = []
    for _ in range(n_steps):
        if stateful:
            inner, ps = state
            action, ps, aux = policy_fn.apply(params, obs, ps, generator)
            state = (inner, ps)
        else:
            action, aux = policy_fn(params, obs, generator)
        state, next_obs, reward, done = stepper(state, action, generator)
        outs.append(StepOut(obs, action, reward, done, next_obs, aux))
        obs = next_obs
    traj = StepOut(*(_stack(field) for field in zip(*outs))) \
        if outs else None
    return state, obs, traj


def _stack(field):
    """One ``StepOut`` field stacked over time: a tensor, a tuple of
    tensors (PPO's ``(logits, value, logp)``) or ``None``."""
    if field[0] is None:
        return None
    if isinstance(field[0], tuple):
        return tuple(torch.stack(f) for f in zip(*field))
    return torch.stack(field)


def evaluate(env: Env, act_fn, params, generator: torch.Generator,
             n_episodes: int, max_steps: int = 1000,
             device=None) -> torch.Tensor:
    """Mean undiscounted return of ``n_episodes`` under ``act_fn``.

    ``act_fn(params, obs) -> action`` is deterministic (``rl.actorq.
    make_act_fn`` over a packed cache, or an fp32 greedy head).  The
    episodes run side by side, each until its first ``done``; rewards
    after it are masked out, as in the reference, and the loop stops once
    every episode is done.  ``device=None`` is ``cuda``.
    """
    device = resolve_device(device)
    benv = batched_env(env, n_episodes)
    state, obs = benv.reset(generator, device)
    done_prev = torch.zeros(n_episodes, device=device)
    total = torch.zeros(n_episodes, device=device)
    for _ in range(max_steps):
        action = act_fn(params, obs)
        state, obs, reward, done = benv.step(state, action, generator)
        total = total + reward * (1.0 - done_prev)
        done_prev = torch.maximum(done_prev, done.to(torch.float32))
        if bool(done_prev.min() > 0):
            break
    return total.mean()
