"""The learner updates of the port across gloo ranks, held to JAX and to
the one-rank update:

* DQN's TD update and DDPG's update with ``reduce`` a 4-rank ``"actor"``
  mean (``rl.distributed.Axis.mean``) against the reference's
  ``dqn.make_td_update`` / ``ddpg.make_update`` with ``reduce=pmean``
  inside ``shard_map`` on a 4-device CPU mesh (one subprocess with
  ``--xla_force_host_platform_device_count=4``, both algorithms), from the
  same state (carried by ``common.state_from_jax``) and per-device
  batches made from a numpy seed: params after the step within 1e-5, the
  loss and the averaged gradients within 1e-6.  Each device's replay
  holds less than ``warmup``, their sum does not: both learn, which only
  the summed size allows;
* the same 4-rank updates against one rank's update on the four batches
  concatenated (grads within 1e-6, params after Adam within 1e-5), and
  ``a2c.make_learner``'s step averaged over 4 ranks, each on a quarter of
  the envs of one trajectory, against the one-rank step on all of it
  (the learner of ``distributed.make_distributed_a2c``).

The ranks and the JAX subprocess start once for the file, side by side.
"""
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import torch_mesh_ranks as R
from repro.rl import ddpg as jddpg
from repro.rl import dqn as jdqn
from repro.rl.envs import make as jmake
from repro.rl.networks import make_network as jmake_network
from repro_torch.rl import a2c, common, ddpg, dqn
from repro_torch.rl import buffer as rb
from repro_torch.rl.env import StepOut
from repro_torch.rl.envs import make
from repro_torch.rl.networks import make_network

ROOT = Path(__file__).resolve().parents[1]
WORLD, BATCH = 4, 16
SIZE = 2              # each device's replay: below warmup 8, the sum not

JAX_SCRIPT = textwrap.dedent("""
    import os, pickle, sys, contextlib
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.rl import buffer as rb, ddpg, dqn
    from repro.rl.distributed import shard_map_compat
    from repro.rl.envs import make
    from repro.rl.networks import make_network

    def mesh_ctx(mesh):
        for name in ("set_mesh", "use_mesh"):
            if hasattr(jax.sharding, name):
                return getattr(jax.sharding, name)(mesh)
        return contextlib.nullcontext()

    SMALL = dict(n_envs=4, rollout_steps=4, updates_per_iter=2,
                 buffer_size=512, batch_size=16, warmup=8)
    inp = pickle.load(open(sys.argv[1], "rb"))
    mesh = jax.make_mesh((4,), ("actor",))
    out = {}
    for algo in ("dqn", "ddpg"):
        if algo == "dqn":
            env = make("cartpole")
            net = make_network(env.spec.obs_shape, env.spec.n_actions)
            cfg = dqn.DQNConfig(**SMALL)
            st = dqn.init(jax.random.PRNGKey(0), env, net, cfg)
            update, grad_calls = dqn.make_td_update(env, net, cfg), (0,)
        else:
            env = make("pendulum")
            nets = ddpg.make_nets(env)
            cfg = ddpg.DDPGConfig(**SMALL)
            st = ddpg.init(jax.random.PRNGKey(0), env, nets, cfg)
            update, grad_calls = ddpg.make_update(env, nets, cfg), (0, 3)

        def body(st, batch, size, update=update, grad_calls=grad_calls):
            seen = []

            def reduce(x):
                y = jax.lax.pmean(x, "actor")
                seen.append(y)
                return y
            b = rb.Transition(*(x[0] for x in batch))
            total = jax.lax.psum(size[0], "actor")
            new, (loss, _) = update(st, b, total, reduce=reduce)
            return new, loss, [seen[i] for i in grad_calls]

        fn = jax.jit(shard_map_compat(
            body, mesh, in_specs=(P(), P("actor"), P("actor")),
            out_specs=(P(), P(), P())))
        batch = tuple(jnp.asarray(x) for x in inp[algo])
        with mesh_ctx(mesh):
            new, loss, grads = fn(st, batch,
                                  jnp.full((4,), inp["size"], jnp.int32))
        out[algo] = dict(
            params=[np.asarray(x) for x in jax.tree_util.tree_leaves(
                (new.params, new.opt, new.extras._replace(replay=())))],
            loss=float(loss),
            grads=[[np.asarray(x) for x in jax.tree_util.tree_leaves(g)]
                   for g in grads],
            updates=int(new.extras.updates))
    pickle.dump(out, open(sys.argv[2], "wb"))
""")


def _batches(algo, rng):
    """Per-device batches ``(WORLD, BATCH, ...)``: obs, action, reward,
    done, next_obs as numpy."""
    shape = (WORLD, BATCH)
    if algo == "dqn":
        obs = (4,)
        action = rng.integers(0, 2, size=shape).astype(np.int32)
    else:
        obs = (3,)
        action = rng.uniform(-2, 2, size=shape + (1,)).astype(np.float32)
    return (rng.normal(size=shape + obs).astype(np.float32), action,
            rng.normal(size=shape).astype(np.float32),
            (rng.uniform(size=shape) < 0.2).astype(np.float32),
            rng.normal(size=shape + obs).astype(np.float32))


def _jax_state(algo):
    if algo == "dqn":
        env = jmake("cartpole")
        net = jmake_network(env.spec.obs_shape, env.spec.n_actions)
        return jdqn.init(jax.random.PRNGKey(0), env, net,
                         jdqn.DQNConfig(**R.SMALL_DQN))
    env = jmake("pendulum")
    return jddpg.init(jax.random.PRNGKey(0), env, jddpg.make_nets(env),
                      jddpg.DDPGConfig(**R.SMALL_DDPG))


def _a2c_case(rng):
    """A fresh A2C state and one ``(T, B)`` CartPole trajectory."""
    env = make("cartpole")
    net = make_network((4,), 3, device="cpu")
    state = a2c.init(torch.Generator().manual_seed(5), env, net,
                     a2c.A2CConfig())
    t, b = 8, 16
    traj = (rng.normal(size=(t, b, 4)).astype(np.float32),
            rng.integers(0, 2, size=(t, b)).astype(np.int32),
            rng.uniform(size=(t, b)).astype(np.float32),
            (rng.uniform(size=(t, b)) < 0.1).astype(np.float32),
            rng.normal(size=(t, b, 4)).astype(np.float32))
    return state, traj, rng.normal(size=(b, 4)).astype(np.float32)


@pytest.fixture(scope="module")
def runs():
    rng = np.random.default_rng(0)
    batches = {a: _batches(a, rng) for a in ("dqn", "ddpg")}
    states = {a: common.state_from_jax(jax.tree_util.tree_map(
        np.asarray, _jax_state(a)), "cpu") for a in ("dqn", "ddpg")}
    a2c_state, traj, last_obs = _a2c_case(rng)
    tmp = Path(tempfile.mkdtemp(prefix="torch_dist_"))
    (tmp / "in.pkl").write_bytes(pickle.dumps(dict(batches, size=SIZE)))
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, str(tmp / "in.pkl"),
         str(tmp / "out.pkl")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        ranks = R.run_worlds({WORLD: [
            (f"update:{a}", dict(algo=a, state=states[a],
                                 batches=batches[a], replay_size=SIZE))
            for a in ("dqn", "ddpg")] + [
            ("a2c_learner", dict(state=a2c_state, traj=traj,
                                 last_obs=last_obs))]})[WORLD]
        log, _ = jax_proc.communicate(timeout=300)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.wait()
    assert jax_proc.returncode == 0, log[-3000:]
    want = pickle.loads((tmp / "out.pkl").read_bytes())
    shutil.rmtree(tmp, ignore_errors=True)
    return dict(ranks=ranks, jax=want, batches=batches, states=states,
                a2c=(a2c_state, traj, last_obs))


def _one_rank_update(algo, state, batches):
    """The update on one rank, the ranks' batches concatenated and their
    replay sizes summed; the gradients each ``reduce`` step saw."""
    if algo == "ddpg":
        env = make("pendulum")
        update = ddpg.make_update(env, ddpg.make_nets(env, device="cpu"),
                                  ddpg.DDPGConfig(**R.SMALL_DDPG))
    else:
        update = dqn.make_td_update(
            make("cartpole"), make_network((4,), 2, device="cpu"),
            dqn.DQNConfig(**R.SMALL_DQN))
    seen = []

    def record(tree):
        seen.append(tree[0])
        return tree
    b = [torch.from_numpy(x.reshape((-1,) + x.shape[2:])) for x in batches]
    new, (loss, _) = update(state, rb.Transition(*b),
                            torch.tensor(SIZE * WORLD), reduce=record)
    return new, float(loss), seen


@pytest.mark.parametrize("algo", ["dqn", "ddpg"])
def test_update_matches_jax_shard_map(runs, algo):
    """Mirrors the sync mesh iteration's learner (tests/
    test_actor_learner.py::test_actor_learner_eight_device_mesh,
    tests/test_prioritized_replay.py:246): one update under the mesh."""
    want = runs["jax"][algo]
    for r in runs["ranks"]:
        got = r[f"update:{algo}"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6,
                                   atol=1e-6)
        assert len(got["grads"]) == len(want["grads"])
        for g_step, w_step in zip(got["grads"], want["grads"]):
            assert len(g_step) == len(w_step)
            for (_, g), w in zip(g_step, w_step):
                np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
        # the JAX side's (params, opt, extras): not the observers (none)
        # or the step
        got_flat = [a for p, a in got["state"]
                    if p.startswith(("/0/", "/1/", "/4/"))]
        assert len(got_flat) == len(want["params"])
        for g, w in zip(got_flat, want["params"]):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    # the summed replay size passed warmup on every device: both learned
    assert want["updates"] == 1


@pytest.mark.parametrize("algo", ["dqn", "ddpg"])
def test_r_rank_update_is_the_one_rank_update(runs, algo):
    new, loss, grads = _one_rank_update(algo, runs["states"][algo],
                                        runs["batches"][algo])
    one = R.leaves(R.replicated(new))
    for r in runs["ranks"]:
        got = r[f"update:{algo}"]
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-6, atol=1e-6)
        for g_step, w_step in zip(got["grads"], grads):
            for (_, g), (_, w) in zip(g_step, R.leaves(w_step)):
                np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
        assert [p for p, _ in got["state"]] == [p for p, _ in one]
        for (p, g), (_, w) in zip(got["state"], one):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                       err_msg=p)
    # every rank holds the same bits
    first = runs["ranks"][0][f"update:{algo}"]["state"]
    for r in runs["ranks"][1:]:
        assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(
            r[f"update:{algo}"]["state"], first))


def test_distributed_a2c_learner_is_the_one_rank_learner(runs):
    state, traj, last_obs = runs["a2c"]
    learn = a2c.make_learner(make("cartpole"),
                             make_network((4,), 3, device="cpu"),
                             a2c.A2CConfig())
    new, met = learn(state, StepOut(*(torch.from_numpy(x) for x in traj),
                                    None), torch.from_numpy(last_obs))
    one = R.leaves(new)
    for r in runs["ranks"]:
        got = r["a2c_learner"]
        np.testing.assert_allclose(got["loss"], float(met["loss"]),
                                   rtol=1e-6, atol=1e-6)
        assert [p for p, _ in got["state"]] == [p for p, _ in one]
        for (p, g), (_, w) in zip(got["state"], one):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                       err_msg=p)
