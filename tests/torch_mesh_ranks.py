"""Gloo ranks on the CPU for the mesh tests of the port.

``run_worlds({world: [(job, kwargs), ...], ...})`` starts every world's
ranks at once, each a process (``python tests/torch_mesh_ranks.py``) that
joins its world through a ``FileStore`` in a temp dir (no TCP port, so
parallel test workers never collide), runs one torch thread, runs its
jobs in order and writes their results, and returns ``{world: [rank 0's
results, rank 1's, ...]}``, each a ``{job: result}`` dict.  A job
``"<name>"`` or ``"<name>:<label>"`` runs ``job_<name>(rank=, world=,
**kwargs)`` of this module; ``kwargs`` are pickled, and so is what it
returns.

This module imports no JAX: the ranks only run the port.
"""
from __future__ import annotations

import hashlib
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"

# tests/test_actor_learner.py:31
SMALL_DQN = dict(n_envs=4, rollout_steps=4, updates_per_iter=2,
                 buffer_size=512, batch_size=16, warmup=8)
SMALL_DDPG = dict(SMALL_DQN)
# tests/test_seq_policy.py:38 and its fused smoke's algo overrides
SEQ_NET = {"d_model": 16, "n_layers": 1, "d_ff": 32}
SEQ_SMOKE = dict(n_envs=2, rollout_steps=2, updates_per_iter=1,
                 buffer_size=64, batch_size=8, warmup=8)
# tests/test_fused_qmlp.py:278-285 and tests/test_async_actor_learner.py:
# 250-254, the two reference mesh tests
RED_CFG = dict(n_envs=4, rollout_steps=4, updates_per_iter=2,
               buffer_size=1024, batch_size=32, warmup=16)

# the world-1 anchors: loops.train on a world-1 mesh against no mesh
ANCHORS = {
    "dqn_al_int8": dict(
        algo="dqn", env_name="cartpole", topology="actor-learner",
        num_actors=4, sync_every=2, actor_backend="int8",
        algo_overrides=SMALL_DQN),
    "dqn_al_int8_per": dict(
        algo="dqn", env_name="cartpole", topology="actor-learner",
        num_actors=4, sync_every=2, actor_backend="int8",
        replay="prioritized", algo_overrides=SMALL_DQN),
    "dqn_async_int4_calib": dict(
        algo="dqn", env_name="cartpole", topology="async", num_actors=4,
        sync_every=4, steps_per_call=2, actor_backend="int4",
        calib_batch=16, algo_overrides=SMALL_DQN),
    "ddpg_al_int8": dict(
        algo="ddpg", env_name="pendulum", topology="actor-learner",
        num_actors=4, sync_every=2, actor_backend="int8",
        algo_overrides=SMALL_DDPG),
    "seq_al_int8": dict(
        algo="dqn", env_name="catch_seq", topology="actor-learner",
        num_actors=2, sync_every=2, actor_backend="int8",
        net_kwargs={"transformer": dict(SEQ_NET)},
        algo_overrides=SEQ_SMOKE),
}
ANCHOR_RUN = dict(iterations=6, record_every=3, eval_episodes=2, seed=3,
                  device="cpu")


def run_worlds(worlds: dict, timeout: float = 240.0) -> dict:
    """Run each world's jobs on its ranks, all worlds at once."""
    tmp = Path(tempfile.mkdtemp(prefix="torch_mesh_"))
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join(
               [str(SRC), str(HERE)] + [p for p in os.environ.get(
                   "PYTHONPATH", "").split(os.pathsep) if p]),
           "OMP_NUM_THREADS": "1"}
    procs = []
    for world, jobs in worlds.items():
        spec = tmp / f"w{world}.jobs"
        spec.write_bytes(pickle.dumps(jobs))
        for rank in range(world):
            log = open(tmp / f"w{world}r{rank}.log", "w")
            procs.append((world, rank, log, subprocess.Popen(
                [sys.executable, str(Path(__file__)), str(world), str(rank),
                 str(tmp / f"w{world}.store"), str(spec),
                 str(tmp / f"w{world}r{rank}.out")],
                env=env, stdout=log, stderr=subprocess.STDOUT)))
    try:
        for world, rank, log, p in procs:
            rc = p.wait(timeout=timeout)
            if rc:
                raise RuntimeError(
                    f"world {world} rank {rank} exited {rc}:\n"
                    + (tmp / f"w{world}r{rank}.log").read_text()[-4000:])
        out = {world: [pickle.loads(
            (tmp / f"w{world}r{r}.out").read_bytes()) for r in range(world)]
            for world in worlds}
    finally:
        for _, _, log, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def rank_main(world: int, rank: int, store: str, spec: str,
              out: str) -> int:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        results = {}
        for name, kwargs in pickle.loads(Path(spec).read_bytes()):
            results[name] = globals()[f"job_{name.split(':')[0]}"](
                rank=rank, world=world, **kwargs)
        Path(out).write_bytes(pickle.dumps(results))
    finally:
        dist.destroy_process_group()
    return 0


# ---------------------------------------------------------------------------
# helpers of the jobs
# ---------------------------------------------------------------------------

def mesh(world: int, name: str = "actor"):
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh("cpu", torch.arange(world), mesh_dim_names=(name,))


def leaves(tree) -> list:
    """``(path, numpy array)`` of every tensor of ``tree``."""
    from repro_torch.core import ptq
    return [(p, t.detach().cpu().numpy()) for p, t in ptq.tree_tensors(tree)]


def digest(tree) -> str:
    """sha256 of every tensor's path, dtype, shape and bytes."""
    h = hashlib.sha256()
    for path, a in leaves(tree):
        h.update(f"{path}|{a.dtype}|{a.shape}|".encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def replicated(learner) -> tuple:
    """A learner ``TrainState`` without its replay (its only per-rank
    leaf)."""
    return (learner.params, learner.opt, learner.observers, learner.step,
            learner.extras._replace(replay=()))


def mismatches(a, b) -> list:
    """Paths where two trees differ (in structure, dtype or any bit)."""
    la, lb = leaves(a), leaves(b)
    if [p for p, _ in la] != [p for p, _ in lb]:
        return ["<structure>"]
    return [p for (p, x), (_, y) in zip(la, lb)
            if x.dtype != y.dtype or x.shape != y.shape
            or x.tobytes() != y.tobytes()]


def same_run(a, b) -> list:
    """What differs between two ``TrainResult``s: every leaf of the final
    state (params, Adam, observers, extras with the replay), the rewards,
    divergences and actor lags."""
    bad = mismatches(a.state, b.state)
    for f in ("rewards", "divergences", "actor_lags", "eval_steps"):
        if getattr(a, f) != getattr(b, f):
            bad.append(f)
    return bad


# ---------------------------------------------------------------------------
# jobs
# ---------------------------------------------------------------------------

def job_anchor(rank, world, config):
    """``loops.train`` of ``ANCHORS[config]`` on a world-1 mesh and with
    no mesh, in this process: what differs."""
    from repro_torch.rl import loops
    kw = dict(ANCHOR_RUN, **ANCHORS[config])
    plain = loops.train(**kw)
    meshed = loops.train(mesh=mesh(world), **kw)
    return dict(diff=same_run(plain, meshed), rewards=meshed.rewards,
                divergences=meshed.divergences)


def job_a2c_anchor(rank, world, backend, calib_batch):
    """``distributed.make_distributed_a2c`` on a world-1 ``"data"`` mesh
    against ``a2c.make_iteration``, 3 iterations from the same state and
    generators: what differs."""
    import torch

    from repro_torch.rl import a2c, distributed
    from repro_torch.rl.envs import make
    from repro_torch.rl.networks import make_network
    env = make("cartpole")
    cfg = a2c.A2CConfig(n_envs=8, n_steps=8, actor_backend=backend,
                        calib_batch=calib_batch)
    net = make_network(env.spec.obs_shape, env.spec.n_actions + 1,
                       device="cpu")
    runs = []
    for m in (None, mesh(world, "data")):
        state = a2c.init(torch.Generator().manual_seed(0), env, net, cfg)
        if m is None:
            iteration, _, benv = a2c.make_iteration(env, net, cfg, "cpu")
        else:
            iteration, _, benv = distributed.make_distributed_a2c(
                env, net, cfg, m, device="cpu")
        env_state, obs = benv.reset(torch.Generator().manual_seed(1), "cpu")
        gen = torch.Generator().manual_seed(2)
        losses = []
        for _ in range(3):
            state, env_state, obs, met = iteration(state, env_state, obs,
                                                   gen)
            losses.append((met["loss"], met["reward"]))
        runs.append((state, env_state, obs, losses))
    return dict(diff=mismatches(runs[0], runs[1]))


def _sync_rounds(world, algo, env_name, cfg_kw, num_actors, sync_every,
                 iters, net_kwargs=None):
    """The synchronous topology on the mesh, ``iters`` iterations: per
    iteration the digest of every replicated leaf, and the last state's
    observations, cache and divergence."""
    import torch

    from repro_torch.rl import actor_learner, ddpg, dqn
    from repro_torch.rl.envs import make
    from repro_torch.rl.networks import make_network
    env = make(env_name)
    if algo == "ddpg":
        net, cfg = ddpg.make_nets(env, device="cpu"), ddpg.DDPGConfig(
            **cfg_kw)
    else:
        net = make_network(env.spec.obs_shape, env.spec.n_actions,
                           device="cpu", **(net_kwargs or {}))
        cfg = dqn.DQNConfig(**cfg_kw)
    al = actor_learner.ActorLearnerConfig(num_actors=num_actors,
                                          sync_every=sync_every)
    m = mesh(world)
    state = actor_learner.init(torch.Generator().manual_seed(0), env, net,
                               algo, cfg, al, mesh=m)
    iteration, _, benv = actor_learner.make_actor_learner(
        algo, env, net, cfg, al, mesh=m, device="cpu")
    index = m.get_local_rank("actor")
    from repro_torch.rl import distributed
    env_state, obs = benv.reset(distributed.rank_generator(
        torch.Generator().manual_seed(1), index), "cpu")
    gen = distributed.rank_generator(torch.Generator().manual_seed(2),
                                     index)
    digests, metrics, updates = [], [], []
    for _ in range(iters):
        state, env_state, obs, met = iteration(state, env_state, obs, gen)
        digests.append(digest((replicated(state.learner),
                               state.actor_params, state.actor_cache,
                               state.divergence)))
        metrics.append({k: v.numpy().copy() for k, v in met.items()})
        updates.append(int(state.learner.extras.updates))
    return dict(digests=digests, metrics=metrics, updates=updates,
                obs=obs.numpy().copy(),
                params=state.actor_params, cache=leaves(state.actor_cache),
                divergence=state.divergence.numpy().copy(),
                shards=int(state.learner.extras.replay.size.shape[0]
                           if hasattr(state.learner.extras.replay, "size")
                           else state.learner.extras.replay.replay.size
                           .shape[0]))


def job_sync(rank, world, **kw):
    return _sync_rounds(world, **kw)


def _async_rounds(world, cfg_kw, num_actors, sync_every, rounds,
                  chunk=2, upd=4):
    """The async programs on the mesh for ``rounds`` rounds, a push after
    each: per round the digest of every replicated leaf and the
    snapshot, and the losses and rewards."""
    import torch

    from repro_torch.rl import actor_learner, distributed, dqn
    from repro_torch.rl.envs import make
    from repro_torch.rl.networks import make_network
    env = make("cartpole")
    cfg = dqn.DQNConfig(**cfg_kw)
    net = make_network(env.spec.obs_shape, env.spec.n_actions, device="cpu")
    al = actor_learner.ActorLearnerConfig(num_actors=num_actors,
                                          sync_every=sync_every)
    m = mesh(world)
    index = m.get_local_rank("actor")
    progs = actor_learner.make_async_actor_learner("dqn", env, net, cfg, al,
                                                   mesh=m, device="cpu")
    learner, wbuf = actor_learner.init_async(
        torch.Generator().manual_seed(0), env, net, "dqn", cfg, al, mesh=m)
    env_state, obs = progs.benv_global.reset(distributed.rank_generator(
        torch.Generator().manual_seed(1), index), "cpu")
    snap = progs.make_snapshot(learner, obs)
    gen = distributed.rank_generator(torch.Generator().manual_seed(2), index)
    digests, losses, rewards, divs = [], [], [], []
    for _ in range(rounds):
        env_state, obs, wbuf, a_m = progs.actor_chunk(
            snap, env_state, obs, wbuf, gen, n_chunks=chunk)
        learner, l_m = progs.learner_chunk(learner, gen, n_updates=upd)
        learner, wbuf = actor_learner.swap_read_slot(learner, wbuf)
        snap = progs.make_snapshot(learner, obs)
        div = progs.divergence(learner, snap, obs)
        digests.append(digest((replicated(learner), snap)))
        losses.append(float(l_m["loss"]))
        rewards.append(float(a_m["reward"]))
        divs.append(div.numpy().copy())
    return dict(digests=digests, losses=losses, rewards=rewards,
                divergences=divs, obs=obs.numpy().copy(),
                params=snap.params, cache=leaves(snap.cache))


def job_async(rank, world, **kw):
    return _async_rounds(world, **kw)


def job_train(rank, world, **kw):
    """``loops.train`` on the mesh: its rewards, divergences, actor lags
    and the digest of the learner's replicated leaves."""
    from repro_torch.rl import loops
    res = loops.train(mesh=mesh(world), device="cpu", **kw)
    return dict(rewards=res.rewards, divergences=res.divergences,
                actor_lags=res.actor_lags,
                digest=digest(replicated(res.state)))


def job_a2c(rank, world, backend, calib_batch, iters=3):
    """``make_distributed_a2c`` on the mesh: per iteration the digest of
    the replicated state, the metrics, and the last observations."""
    import torch

    from repro_torch.rl import a2c, distributed
    from repro_torch.rl.envs import make
    from repro_torch.rl.networks import make_network
    env = make("cartpole")
    cfg = a2c.A2CConfig(n_envs=8, n_steps=8, actor_backend=backend,
                        calib_batch=calib_batch)
    net = make_network(env.spec.obs_shape, env.spec.n_actions + 1,
                       device="cpu")
    m = mesh(world, "data")
    state = a2c.init(torch.Generator().manual_seed(0), env, net, cfg)
    iteration, _, benv = distributed.make_distributed_a2c(
        env, net, cfg, m, device="cpu")
    index = m.get_local_rank("data")
    env_state, obs = benv.reset(distributed.rank_generator(
        torch.Generator().manual_seed(1), index), "cpu")
    gen = distributed.rank_generator(torch.Generator().manual_seed(2), index)
    digests, metrics = [], []
    for _ in range(iters):
        state, env_state, obs, met = iteration(state, env_state, obs, gen)
        digests.append(digest(state))
        metrics.append({k: float(v) for k, v in met.items()})
    return dict(digests=digests, metrics=metrics, envs=int(obs.shape[0]))


def job_raises(rank, world):
    """The mesh's rejections: each case's exception type and message."""
    from repro_torch.rl import a2c, actor_learner, distributed, dqn, loops
    from repro_torch.rl.envs import make
    from repro_torch.rl.networks import make_network
    out = {}
    env = make("cartpole")
    net = make_network((4,), 2, device="cpu")

    def catch(name, fn):
        try:
            fn()
            out[name] = None
        except Exception as e:           # noqa: BLE001 -- reported back
            out[name] = (type(e).__name__, str(e))
    catch("num_actors", lambda: actor_learner.make_actor_learner(
        "dqn", env, net, dqn.DQNConfig(**SMALL_DQN),
        actor_learner.ActorLearnerConfig(num_actors=world + 1),
        mesh=mesh(world), device="cpu"))
    catch("num_actors_train", lambda: loops.train(
        "dqn", "cartpole", topology="async", num_actors=world + 1,
        iterations=1, algo_overrides=SMALL_DQN, mesh=mesh(world),
        device="cpu"))
    catch("n_envs", lambda: distributed.make_distributed_a2c(
        env, make_network((4,), 3, device="cpu"),
        a2c.A2CConfig(n_envs=world + 1), mesh(world, "data"),
        device="cpu"))
    catch("axis", lambda: distributed.Axis(mesh(world, "data"), "actor"))
    return out


def job_batcher(rank, world):
    """``ShardedBatcher.put`` with the ``(world, 1)`` host mesh and
    without a mesh, on one batch."""
    from repro_torch.data import ShardedBatcher
    from repro_torch.launch import mesh as lmesh
    m = lmesh.make_host_mesh(device="cpu")
    batch = {"tokens": np.arange(4 * world * 3).reshape(4 * world, 3),
             "w": np.linspace(0, 1, 4 * world, dtype=np.float32)}
    got = ShardedBatcher(m, device="cpu").put(batch)
    whole = ShardedBatcher(None, device="cpu").put(batch)
    return dict(mesh={k: v.numpy() for k, v in got.items()},
                whole={k: v.numpy() for k, v in whole.items()},
                dims=m.mesh_dim_names, shape=tuple(m.shape),
                index=m.get_local_rank("data"),
                from_iter=[b["w"].numpy() for b in ShardedBatcher(
                    m, device="cpu")(iter([batch, batch]))])


def _update_parts(algo):
    import torch

    from repro_torch.rl import ddpg, dqn
    from repro_torch.rl.envs import make
    from repro_torch.rl.networks import make_network
    if algo == "ddpg":
        env = make("pendulum")
        return (ddpg.make_update(env, ddpg.make_nets(env, device="cpu"),
                                 ddpg.DDPGConfig(**SMALL_DDPG)),
                torch.float32)
    env = make("cartpole")
    return (dqn.make_td_update(env, make_network((4,), 2, device="cpu"),
                               dqn.DQNConfig(**SMALL_DQN)), torch.int32)


def job_update(rank, world, algo, state, batches, replay_size):
    """One learner update of ``algo`` on this rank's ``batches[rank]``
    (numpy ``Transition`` fields) from ``state``, its gradients, loss and
    observers averaged over the ``"actor"`` axis: the new state, the loss
    and each ``reduce`` call's averaged gradients."""
    import torch

    from repro_torch.rl import buffer as rb
    from repro_torch.rl import distributed
    update, action_dtype = _update_parts(algo)
    ax = distributed.Axis(mesh(world), "actor")
    seen = []

    def reduce(tree):
        out = ax.mean(tree)
        seen.append(out[0])
        return out
    b = [torch.from_numpy(np.asarray(x[rank])) for x in batches]
    batch = rb.Transition(b[0], b[1].to(action_dtype), b[2], b[3], b[4])
    new, (loss, _) = update(state, batch,
                            ax.sum(torch.tensor(replay_size)), reduce=reduce)
    return dict(state=leaves(replicated(new)), loss=float(loss),
                grads=[leaves(g) for g in seen])


def job_a2c_learner(rank, world, state, traj, last_obs):
    """``a2c.make_learner``'s step on this rank's slice of the envs of
    ``traj`` (numpy ``StepOut`` fields, ``(T, B, ...)``), averaged over
    the ``"data"`` axis: the new state and the loss."""
    import torch

    from repro_torch.rl import a2c, distributed
    from repro_torch.rl.env import StepOut
    from repro_torch.rl.envs import make
    from repro_torch.rl.networks import make_network
    env = make("cartpole")
    learn = a2c.make_learner(env, make_network((4,), 3, device="cpu"),
                             a2c.A2CConfig())
    ax = distributed.Axis(mesh(world, "data"), "data")
    b = traj[0].shape[1] // world
    rows = slice(rank * b, (rank + 1) * b)
    part = StepOut(*(torch.from_numpy(np.asarray(x[:, rows]))
                     for x in traj[:5]), None)
    new, met = learn(state, part,
                     torch.from_numpy(np.asarray(last_obs[rows])),
                     reduce=ax.mean)
    return dict(state=leaves(new), loss=float(met["loss"]))


if __name__ == "__main__":
    sys.path[:0] = [str(SRC), str(HERE)]
    w, r, store_path, spec_path, out_path = sys.argv[1:]
    sys.exit(rank_main(int(w), int(r), store_path, spec_path, out_path))
