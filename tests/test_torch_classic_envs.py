"""Port parity: the batched MountainCar (discrete and continuous) and
Pendulum envs (``repro_torch.rl.envs.mountaincar`` / ``pendulum``).

The two packages draw resets from different generators, so states are
built with numpy and handed to both: one step from the same state and
action must agree within 1e-6 (float32 ops in another library; the
pendulum's angle wrap is a float remainder in each), with the step
counter and ``done`` exact.  Resets are held to the reference's ranges
and to their seed.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.rl.envs import make as jmake
from repro.rl.envs.mountaincar import MCState as JMCState
from repro.rl.envs.pendulum import PendulumState as JPendulumState
from repro_torch.rl.env import batched_env
from repro_torch.rl.envs import make
from repro_torch.rl.envs.mountaincar import MCState
from repro_torch.rl.envs.pendulum import PendulumState

N = 64


def _mc_states(seed, t0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1.2, 0.6, size=N).astype(np.float32)
    pos[:4] = (-1.2, 0.6, 0.5, -0.5)           # both walls and the goal
    vel = rng.uniform(-0.07, 0.07, size=N).astype(np.float32)
    vel[0] = -0.07                              # into the left wall
    return dict(pos=pos, vel=vel, t=np.full(N, t0, np.int32))


def _pendulum_states(seed, t0):
    rng = np.random.default_rng(seed)
    return dict(theta=rng.uniform(-3 * np.pi, 3 * np.pi, size=N
                                  ).astype(np.float32),
                theta_dot=rng.uniform(-8.0, 8.0, size=N).astype(np.float32),
                t=np.full(N, t0, np.int32))


def _actions(name, seed):
    rng = np.random.default_rng(seed)
    if name == "mountaincar":
        return (np.arange(N) % 3).astype(np.int32)
    # continuous: a force / torque past the clip on both sides
    return rng.uniform(-3.0, 3.0, size=(N, 1)).astype(np.float32)


CASES = {"mountaincar": (_mc_states, JMCState, MCState, ("pos", "vel")),
         "mountaincar_continuous": (_mc_states, JMCState, MCState,
                                    ("pos", "vel")),
         "pendulum": (_pendulum_states, JPendulumState, PendulumState,
                      ("theta", "theta_dot"))}


@pytest.mark.parametrize("t0", [0, 198, 998])
@pytest.mark.parametrize("name", sorted(CASES))
def test_step_matches_jax(name, t0):
    states, jcls, tcls, fields = CASES[name]
    raw = states(seed=t0 + len(name), t0=t0)
    actions = _actions(name, seed=t0)
    jenv = jmake(name)
    js = jcls(**{k: jnp.asarray(v) for k, v in raw.items()})
    jout = jax.vmap(jenv.step)(js, jnp.asarray(actions),
                               jax.random.split(jax.random.PRNGKey(0), N))
    tenv = make(name)
    ts = tcls(**{k: torch.from_numpy(v) for k, v in raw.items()})
    tout = tenv.step(ts, torch.from_numpy(actions))
    pairs = [("obs", jout[1], tout[1]), ("reward", jout[2], tout[2])]
    pairs += [(f, getattr(jout[0], f), getattr(tout[0], f)) for f in fields]
    for what, j, t in pairs:
        assert tuple(t.shape) == tuple(j.shape), what
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                   atol=1e-6, err_msg=what)
    np.testing.assert_array_equal(tout[3].numpy(), np.asarray(jout[3]))
    np.testing.assert_array_equal(tout[0].t.numpy(), np.asarray(jout[0].t))
    assert tout[3].dtype == torch.float32
    if t0 + 1 >= tenv.spec.max_steps:
        assert bool((tout[3] == 1).all())                  # timeout


@pytest.mark.parametrize("name", sorted(CASES))
def test_reset_is_seeded_in_range_and_specced_as_jax(name):
    env = batched_env(make(name), 256)
    s, obs = env.reset(torch.Generator().manual_seed(0), "cpu")
    s2, obs2 = env.reset(torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(obs, obs2) and bool((s.t == 0).all())
    jspec = jmake(name).spec
    spec = env.spec
    assert (spec.obs_shape, spec.n_actions, spec.action_dim,
            spec.action_scale, spec.max_steps) == (
        jspec.obs_shape, jspec.n_actions, jspec.action_dim,
        jspec.action_scale, jspec.max_steps)
    assert tuple(obs.shape) == (256,) + spec.obs_shape
    if name.startswith("mountaincar"):
        assert bool(((s.pos >= -0.6) & (s.pos <= -0.4)).all())
        assert bool((s.vel == 0).all())
    else:
        assert bool((s.theta.abs() <= math.pi).all())
        assert bool((s.theta_dot.abs() <= 1.0).all())
        torch.testing.assert_close(obs[:, 0], torch.cos(s.theta))
        torch.testing.assert_close(obs[:, 1], torch.sin(s.theta))
