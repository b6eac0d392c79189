"""Port parity: the batched AirNav env (``repro_torch.rl.envs.airnav``).

The two packages draw resets from different generators, so states are
built with numpy and handed to both: one step from the same state and
action must agree within 1e-6 (float32 ops in another order/library).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.rl.envs.airnav import AirNavState as JState
from repro.rl.envs.airnav import make_airnav as jmake_airnav
from repro_torch.rl.env import batched_env
from repro_torch.rl.envs import make
from repro_torch.rl.envs.airnav import AirNavState, make_airnav


def _states(n, seed, t0=0):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    n_active = rng.integers(1, 6, size=(n, 1))
    obstacles = np.concatenate([
        rng.uniform(3.0, 22.0, size=(n, 5, 2)),
        (np.arange(5)[None] < n_active)[..., None]], -1).astype(f32)
    return dict(pos=rng.uniform(0.0, 25.0, size=(n, 2)).astype(f32),
                vel=rng.uniform(-2.5, 2.5, size=(n, 2)).astype(f32),
                heading=rng.uniform(-np.pi, np.pi, size=n).astype(f32),
                goal=rng.uniform(2.0, 23.0, size=(n, 2)).astype(f32),
                obstacles=obstacles,
                t=np.full(n, t0, np.int32))


@pytest.mark.parametrize("t0", [0, 299])
def test_step_matches_jax(t0):
    n = 64
    raw = _states(n, seed=t0, t0=t0)
    actions = np.arange(n) % 25
    jenv = jmake_airnav()
    js = JState(**{k: jnp.asarray(v) for k, v in raw.items()})
    jout = jax.vmap(jenv.step)(js, jnp.asarray(actions, jnp.int32),
                               jax.random.split(jax.random.PRNGKey(0), n))
    tenv = make_airnav()
    ts = AirNavState(**{k: torch.from_numpy(v) for k, v in raw.items()})
    tout = tenv.step(ts, torch.from_numpy(actions))
    for name, j, t in (("obs", jout[1], tout[1]),
                       ("reward", jout[2], tout[2]),
                       ("done", jout[3], tout[3]),
                       ("pos", jout[0].pos, tout[0].pos),
                       ("heading", jout[0].heading, tout[0].heading)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(tout[0].t.numpy(), np.asarray(jout[0].t))
    if t0 == 299:
        assert bool((tout[3] == 1).all())                  # timeout


def test_reset_is_seeded_and_in_range():
    env = batched_env(make("airnav"), 128)
    s, obs = env.reset(torch.Generator().manual_seed(0), "cpu")
    s2, obs2 = env.reset(torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(obs, obs2) and tuple(obs.shape) == (128, 9)
    assert bool(((s.pos >= 2.0) & (s.pos <= 23.0)).all())
    active = s.obstacles[..., 2].sum(-1)
    assert bool(((active >= 1) & (active <= 5)).all())
    assert bool((s.vel == 0).all()) and bool((s.t == 0).all())
    assert env.spec.n_actions == 25 and env.spec.obs_shape == (9,)
    # every env of the reference is registered now (pendulum and
    # mountaincar: tests/test_torch_classic_envs.py); a name outside the
    # registry raises
    assert make("pendulum").spec.obs_shape == (3,)
    with pytest.raises(KeyError, match="unknown env"):
        make("pong")
