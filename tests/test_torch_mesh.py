"""The actor mesh of the port on the CPU: ``loops.train(mesh=...)``,
``actor_learner.make_actor_learner`` / ``make_async_actor_learner`` and
``distributed.make_distributed_a2c`` across gloo ranks (one process a
rank, ``tests/torch_mesh_ranks.py``), held to the port's own no-mesh
paths (which the other test files hold to JAX) and to the reference's
replication contract:

* a world-1 mesh is bitwise the no-mesh run (params, Adam, observers,
  replay, rewards, divergences): DQN int8 on CartPole with 4 actors and a
  push every 2 iterations, the same with prioritized replay, async DQN
  int4 calibrated, DDPG int8 on Pendulum, the ``catch_seq`` sequence
  actor; and distributed A2C is ``a2c.make_iteration``;
* at worlds 2 and 4 every replicated leaf (learner params, Adam state,
  observers, target nets, actor params, packed cache) is bitwise equal
  across ranks after every iteration, in both topologies, uniform and
  prioritized; the divergence is gathered to ``(num_actors,)``; a
  calibrated cache is bitwise ``actorq.make_actor_cache`` on every rank's
  observations concatenated in rank order;
* the port's counterparts of the reference's two mesh tests that crash
  in this JAX version (a mesh meeting buffer donation, ROADMAP queue C)
  pass: the calibrated int4 actor-learner run through ``loops.train`` and
  the async mesh programs, on 4 ranks, with finite rewards and losses;
* the rejections (``num_actors`` or ``n_envs`` not dividing by the world,
  a fused mesh, a mesh with checkpoints or the supervisor);
* ``data.ShardedBatcher`` with and without a mesh.

The ranks start once for the file (``ranks``), every world at once.
"""
import numpy as np
import pytest
import torch

import torch_mesh_ranks as R
from repro_torch.core import ptq
from repro_torch.resilience import ResilienceContext
from repro_torch.rl import actorq, loops

SYNC = {
    "dqn_uniform": dict(algo="dqn", env_name="cartpole",
                        cfg_kw=dict(R.SMALL_DQN, actor_backend="int8")),
    "dqn_per": dict(algo="dqn", env_name="cartpole",
                    cfg_kw=dict(R.SMALL_DQN, actor_backend="int8",
                                replay="prioritized")),
    "dqn_int4_calib": dict(algo="dqn", env_name="cartpole",
                           cfg_kw=dict(R.SMALL_DQN, actor_backend="int4",
                                       calib_batch=12)),
    "ddpg_uniform": dict(algo="ddpg", env_name="pendulum",
                         cfg_kw=dict(R.SMALL_DDPG, actor_backend="int8")),
    # the first iteration writes 64 transitions over all ranks, 32 or 16
    # a rank: only the summed size passes the warmup gate
    "dqn_warmup": dict(algo="dqn", env_name="cartpole",
                       cfg_kw=dict(R.SMALL_DQN, warmup=40)),
}
ASYNC = {
    "uniform": dict(R.SMALL_DQN, actor_backend="int8"),
    "per": dict(R.SMALL_DQN, actor_backend="int8", replay="prioritized"),
    "int4_calib": dict(R.SMALL_DQN, actor_backend="int4", calib_batch=12),
}
ITERS, ROUNDS = 4, 3
# tests/test_fused_qmlp.py:278-285 through loops.train
RED_TRAIN = dict(algo="dqn", env_name="cartpole", topology="actor-learner",
                 num_actors=4, sync_every=2, actor_backend="int4",
                 calib_batch=16, iterations=4, record_every=2,
                 eval_episodes=2, algo_overrides=R.RED_CFG)
# both topologies through loops.train: every rank returns the same run
TRAIN = {
    "actor-learner": dict(algo="dqn", env_name="cartpole",
                          topology="actor-learner", num_actors=4,
                          sync_every=2, actor_backend="int8", iterations=4,
                          record_every=2, eval_episodes=2,
                          algo_overrides=R.SMALL_DQN),
    "async": dict(algo="dqn", env_name="cartpole", topology="async",
                  num_actors=4, sync_every=4, steps_per_call=2,
                  actor_backend="int4", calib_batch=16, iterations=4,
                  record_every=2, eval_episodes=2,
                  algo_overrides=R.SMALL_DQN),
}


def _world_jobs(world):
    jobs = [(f"sync:{k}", dict(v, num_actors=4, sync_every=2, iters=ITERS))
            for k, v in SYNC.items()]
    jobs += [(f"async:{k}", dict(cfg_kw=v, num_actors=4, sync_every=4,
                                 rounds=ROUNDS)) for k, v in ASYNC.items()]
    jobs += [(f"train:{k}", v) for k, v in TRAIN.items()]
    jobs += [("raises", {}), ("batcher", {})]
    if world == 4:
        # the counterparts of the two reference mesh tests
        jobs += [("train:red", RED_TRAIN),
                 ("async:red", dict(cfg_kw=dict(R.RED_CFG,
                                                actor_backend="int8"),
                                    num_actors=4, sync_every=8, rounds=4))]
    return jobs


@pytest.fixture(scope="module")
def ranks():
    return R.run_worlds({
        1: [(f"anchor:{k}", dict(config=k)) for k in R.ANCHORS]
        + [(f"a2c_anchor:{b}", dict(backend=b, calib_batch=c))
           for b, c in (("fp32", 0), ("int8", 0), ("int4", 8))],
        2: _world_jobs(2),
        4: _world_jobs(4)})


def _np(tree_leaves):
    return [a for _, a in tree_leaves]


# ---------------------------------------------------------------------------
# world 1: bitwise the no-mesh run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("config", sorted(R.ANCHORS))
def test_world1_mesh_is_bitwise_the_no_mesh_run(ranks, config):
    got = ranks[1][0][f"anchor:{config}"]
    assert got["diff"] == []
    assert got["rewards"] and all(np.isfinite(got["rewards"]))
    assert got["divergences"] and all(
        len(d) == R.ANCHORS[config]["num_actors"] for d in got["divergences"])


@pytest.mark.parametrize("backend", ["fp32", "int8", "int4"])
def test_world1_distributed_a2c_is_bitwise_a2c(ranks, backend):
    """Mirrors tests/test_distributed_rl.py::test_distributed_a2c_one_device
    and its int8 case: three iterations bitwise a2c.make_iteration's."""
    assert ranks[1][0][f"a2c_anchor:{backend}"]["diff"] == []


# ---------------------------------------------------------------------------
# worlds 2 and 4: the replication contract
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("run", sorted(SYNC))
def test_sync_replicated_leaves_bitwise_across_ranks(ranks, world, run):
    """Mirrors tests/test_actor_learner.py::
    test_actor_learner_eight_device_mesh: after every iteration the
    learner (params, Adam, observers, targets), the actors' params, the
    cache and the gathered divergence are the same bits on every rank;
    each rank holds its own replay shards."""
    per = [r[f"sync:{run}"] for r in ranks[world]]
    for it in range(ITERS):
        assert len({p["digests"][it] for p in per}) == 1, it
    assert all(p["shards"] == 4 // world for p in per)
    for p in per:
        assert p["divergence"].shape == (4,)
        assert np.isfinite(p["divergence"]).all()
        assert np.isfinite(p["metrics"][-1]["loss"])
    # the ranks' own observations differ (their own generators)
    assert not all(np.array_equal(per[0]["obs"], p["obs"]) for p in per[1:])


@pytest.mark.parametrize("world", [2, 4])
def test_warmup_gate_reads_the_summed_replay_size(ranks, world):
    """The reference's psum'd ``total_size`` (src/repro/rl/actor_learner.py
    :535-537): every rank learns from the first iteration, where its own
    shards hold less than ``warmup``."""
    per = [r["sync:dqn_warmup"] for r in ranks[world]]
    for p in per:
        assert p["updates"] == [2 * (i + 1) for i in range(ITERS)]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("run", sorted(ASYNC))
def test_async_replicated_leaves_bitwise_across_ranks(ranks, world, run):
    per = [r[f"async:{run}"] for r in ranks[world]]
    for k in range(ROUNDS):
        assert len({p["digests"][k] for p in per}) == 1, k
    for p in per:
        assert p["losses"] == per[0]["losses"]
        assert p["rewards"] == per[0]["rewards"]
        assert all(d.shape == (4,) and np.isfinite(d).all()
                   for d in p["divergences"])


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("topology", ["sync", "async"])
def test_calibrated_cache_is_the_pack_of_the_gathered_obs(ranks, world,
                                                          topology):
    """The calibrated pack at a push reads every rank's observations in
    rank order (the reference's ``all_gather(..., tiled=True)`` before
    ``calib_slice``): bitwise ``make_actor_cache`` here on their
    concatenation."""
    name = "sync:dqn_int4_calib" if topology == "sync" \
        else "async:int4_calib"
    per = [r[name] for r in ranks[world]]
    obs = torch.from_numpy(np.concatenate([p["obs"] for p in per]))
    want = actorq.make_actor_cache(per[0]["params"], "int4",
                                   calib_obs=actorq.calib_slice(obs, 12))
    want = [t.numpy() for _, t in ptq.tree_tensors(want)]
    for p in per:
        got = _np(p["cache"])
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("topology", sorted(TRAIN))
def test_train_returns_the_same_run_on_every_rank(ranks, world, topology):
    per = [r[f"train:{topology}"] for r in ranks[world]]
    for p in per[1:]:
        assert p == per[0]
    assert all(np.isfinite(per[0]["rewards"]))
    assert all(len(d) == 4 for d in per[0]["divergences"])


# ---------------------------------------------------------------------------
# the reference's two red mesh tests, on the port
# ---------------------------------------------------------------------------

def test_int4_calibrated_actor_learner_four_rank_mesh(ranks):
    """Mirrors tests/test_fused_qmlp.py::
    test_int4_calibrated_actor_learner_four_device_mesh (which crashes in
    this JAX version where the mesh meets buffer donation)."""
    per = [r["train:red"] for r in ranks[4]]
    assert all(np.isfinite(per[0]["rewards"]))
    assert len(per[0]["divergences"]) > 0
    assert all(p == per[0] for p in per)


def test_async_actor_learner_four_rank_mesh(ranks):
    """Mirrors tests/test_async_actor_learner.py::
    test_async_actor_learner_four_device_mesh (which crashes in this JAX
    version): 4 rounds of 2 rollouts and 4 updates, a push each."""
    per = [r["async:red"] for r in ranks[4]]
    for p in per:
        assert np.isfinite(p["losses"]).all()
        assert np.isfinite(p["rewards"]).all()
        assert p["divergences"][-1].shape == (4,)
        assert np.isfinite(p["divergences"][-1]).all()
        assert p["digests"] == per[0]["digests"]


# ---------------------------------------------------------------------------
# rejections
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
def test_mesh_rejections(ranks, world):
    """Mirrors tests/test_actor_learner.py's divisibility contracts and
    make_distributed_a2c's ``n_envs % n_dev`` (an assert there, a
    ValueError here)."""
    got = ranks[world][0]["raises"]
    assert got["num_actors"][0] == "ValueError"
    assert "must divide by the mesh 'actor' axis" in got["num_actors"][1]
    assert got["num_actors_train"][0] == "ValueError"
    assert got["n_envs"] == ("ValueError",
                             f"n_envs {world + 1} must divide by the mesh "
                             f"'data' axis size {world}")
    assert got["axis"][0] == "ValueError"


def test_fused_mesh_and_unported_mesh_options_raise(tmp_path):
    """``mesh`` is an actor-learner knob (the reference's ValueError, its
    loops.py:336-338); a mesh with checkpoints or the resilience hooks is
    not ported (item 14c)."""
    with pytest.raises(ValueError, match="actor-learner knobs"):
        loops.train("dqn", "cartpole", mesh=object(), iterations=1,
                    device="cpu")
    for topo in ("actor-learner", "async"):
        kw = dict(topology=topo, num_actors=2, iterations=1, device="cpu",
                  mesh=object())
        for extra in (dict(checkpoint_dir=str(tmp_path)),
                      dict(resume=True, checkpoint_dir=str(tmp_path)),
                      dict(resilience=ResilienceContext())):
            with pytest.raises(NotImplementedError, match="item 14c"):
                loops.train("ddpg", "pendulum", **kw, **extra)


# ---------------------------------------------------------------------------
# the sharded batcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
def test_sharded_batcher(ranks, world):
    """Without a mesh ``put`` is the whole batch; with the host mesh
    ``(world, 1)`` over ``("data", "model")`` each rank takes its slice
    of the batch dim, in rank order."""
    per = [r["batcher"] for r in ranks[world]]
    whole = per[0]["whole"]
    assert whole["tokens"].shape == (4 * world, 3)
    for k in ("tokens", "w"):
        np.testing.assert_array_equal(
            np.concatenate([p["mesh"][k] for p in per]), whole[k])
    for i, p in enumerate(per):
        assert p["dims"] == ("data", "model") and p["shape"] == (world, 1)
        assert p["index"] == i
        assert p["mesh"]["tokens"].dtype == whole["tokens"].dtype
        assert all(np.array_equal(b, p["mesh"]["w"]) for b in p["from_iter"])
