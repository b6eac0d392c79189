"""The actor-learner and async topologies of the port
(``repro_torch.rl.actor_learner``, ``loops.train(topology=...)``): their
contracts inside the port, on the CPU, and the per-actor divergence head
against the JAX package.

Inside the port, bitwise (one generator drawn in host order in every
topology):

* actor-learner with one actor and a push every iteration is the fused
  driver, also chunked;
* async in barrier mode with rounds of one rollout and a push every
  ``updates_per_iter`` updates is the actor-learner run, fp32 and int8;
* ``priority_exponent=0`` is ``replay="uniform"`` in all three
  topologies.

Against JAX: ``_make_divergence`` on the same params and observations
within 1e-5 (a dynamic activation code may flip across packages, ROADMAP
queue C: then within 5e-3, and the flip is printed), with each actor's
input codes and scale bitwise JAX's per-actor quantization.

Each test names the reference test it mirrors.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import affine as jaffine
from repro.rl import actor_learner as jal
from repro.rl import actorq as jactorq
from repro.rl import dqn as jdqn
from repro.rl.envs import make as jmake
from repro.rl.networks import make_network as jmake_network
from repro_torch.core import affine, ptq
from repro_torch.kernels import ops
from repro_torch.resilience import ResilienceContext
from repro_torch.rl import actor_learner, actorq, common, dqn, loops
from repro_torch.rl import buffer as rb
from repro_torch.rl import networks
from repro_torch.rl.envs import make

# tests/test_actor_learner.py:31
SMALL_DQN = dict(n_envs=4, rollout_steps=4, updates_per_iter=2,
                 buffer_size=512, batch_size=16, warmup=8)
RUN = dict(iterations=6, record_every=3, eval_episodes=2,
           algo_overrides=dict(SMALL_DQN), device="cpu")


def _flat(tree):
    return [t for _, t in ptq.tree_tensors(tree)]


def _assert_same_run(a, b):
    assert a.rewards == b.rewards
    assert a.divergences == b.divergences
    assert int(a.state.extras.updates) == int(b.state.extras.updates)
    for x, y in zip(_flat(a.state.params), _flat(b.state.params)):
        assert torch.equal(x, y)
    for x, y in zip(_flat(a.state.extras.target_params),
                    _flat(b.state.extras.target_params)):
        assert torch.equal(x, y)


def _small_cfg(**kw):
    return dqn.DQNConfig(**dict(SMALL_DQN, **kw))


def _cartpole():
    env = make("cartpole")
    return env, networks.make_network(env.spec.obs_shape,
                                      env.spec.n_actions, device="cpu")


# ---------------------------------------------------------------------------
# the bitwise anchors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["fp32", "int8"])
def test_single_actor_parity_with_fused_dqn(backend):
    """Mirrors test_actor_learner.py::
    test_single_actor_parity_with_fused_dqn."""
    kw = dict(RUN, seed=7, actor_backend=backend)
    fused = loops.train("dqn", "cartpole", **kw)
    al = loops.train("dqn", "cartpole", topology="actor-learner",
                     num_actors=1, sync_every=1, **kw)
    assert al.divergences and fused.divergences == []
    al = dataclasses.replace(al, divergences=[])
    _assert_same_run(fused, al)


def test_single_actor_parity_survives_chunked_driver():
    """Mirrors test_actor_learner.py::
    test_single_actor_parity_survives_scan_fused_driver."""
    kw = dict(RUN, seed=11)
    fused = loops.train("dqn", "cartpole", steps_per_call=1, **kw)
    al = loops.train("dqn", "cartpole", topology="actor-learner",
                     num_actors=1, sync_every=1, steps_per_call=3, **kw)
    _assert_same_run(fused, dataclasses.replace(al, divergences=[]))


@pytest.mark.parametrize("backend", ["fp32", "int8"])
def test_async_barrier_anchor_matches_synchronous_driver(backend):
    """Mirrors test_async_actor_learner.py::
    test_async_barrier_anchor_matches_synchronous_driver and
    test_async_barrier_anchor_with_int8_actors: divergences too, since
    every push of either run sees the same learner and actors."""
    kw = dict(RUN, seed=7, actor_backend=backend)
    sync = loops.train("dqn", "cartpole", topology="actor-learner",
                       num_actors=1, sync_every=1, **kw)
    anc = loops.train("dqn", "cartpole", topology="async", num_actors=1,
                      sync_every=SMALL_DQN["updates_per_iter"],
                      async_barrier=True, steps_per_call=1, **kw)
    assert sync.rewards == anc.rewards
    assert anc.actor_lags == [SMALL_DQN["updates_per_iter"]] * 6
    # the sync run records a push at each record point, async at each push
    assert sync.divergences == anc.divergences[2::3]
    _assert_same_run(sync, dataclasses.replace(
        anc, divergences=anc.divergences[2::3]))


@pytest.mark.parametrize("topo", [
    {}, dict(topology="actor-learner", num_actors=2, sync_every=2),
    dict(topology="async", num_actors=2, sync_every=4, steps_per_call=2),
    dict(topology="actor-learner", num_actors=2, sync_every=1,
         steps_per_call=3, actor_backend="int8")], ids=str)
def test_priority_exponent_zero_is_bitwise_uniform(topo):
    """Mirrors test_prioritized_replay.py::
    test_priority_exponent_zero_is_bitwise_uniform."""
    kw = dict(RUN, seed=13, **topo)
    uniform = loops.train("dqn", "cartpole", replay="uniform", **kw)
    alpha0 = loops.train("dqn", "cartpole", replay="prioritized",
                         priority_exponent=0.0, **kw)
    _assert_same_run(uniform, alpha0)
    assert isinstance(alpha0.state.extras.replay, rb.ReplayState)


@pytest.mark.parametrize("topo", [
    {}, dict(topology="actor-learner", num_actors=2, sync_every=2),
    dict(topology="async", num_actors=2, sync_every=4, steps_per_call=2)],
    ids=str)
def test_prioritized_state_carries_sum_tree(topo):
    """Mirrors test_prioritized_replay.py::
    test_prioritized_state_carries_sum_tree and
    test_priority_exponent_nonzero_changes_sampling, in all three
    topologies: the replay is a sum-tree (one a shard), priorities were
    pushed, and the run differs from the uniform one."""
    kw = dict(RUN, seed=13, **topo)
    per = loops.train("dqn", "cartpole", replay="prioritized", **kw)
    uniform = loops.train("dqn", "cartpole", **kw)
    replay = per.state.extras.replay
    assert isinstance(replay, rb.PrioritizedReplayState)
    leaves = rb.sum_tree_leaves(replay.tree)
    assert bool(torch.isfinite(leaves).all())
    torch.testing.assert_close(rb.sum_tree_total(replay.tree),
                               leaves.sum(-1), rtol=1e-4, atol=0)
    written = leaves[..., :int(replay.replay.size.reshape(-1)[0])]
    assert len(torch.unique(written)) > 1
    assert any(not torch.equal(x, y) for x, y in zip(
        _flat(per.state.params), _flat(uniform.state.params)))
    assert float(common.per_beta(per.state, per.algo_cfg)) > 0.4


# ---------------------------------------------------------------------------
# the synchronous topology
# ---------------------------------------------------------------------------

def _al_run(backend, sync_every, iterations):
    env, net = _cartpole()
    cfg = _small_cfg(warmup=1, actor_backend=backend)
    al = actor_learner.ActorLearnerConfig(num_actors=2,
                                          sync_every=sync_every)
    state = actor_learner.init(torch.Generator().manual_seed(0), env, net,
                               "dqn", cfg, al)
    iteration, _, benv = actor_learner.make_actor_learner(
        "dqn", env, net, cfg, al, device="cpu")
    env_state, obs = benv.reset(torch.Generator().manual_seed(1), "cpu")
    gen = torch.Generator().manual_seed(2)
    states = [state]
    for _ in range(iterations):
        state, env_state, obs, _ = iteration(state, env_state, obs, gen)
        states.append(state)
    return states


def test_sync_every_staleness_contract():
    """Mirrors test_actor_learner.py::test_sync_every_staleness_contract:
    between pushes the actors keep the init-time copy; the push at
    t == sync_every hands them the learner's params."""
    states = _al_run("fp32", 3, 3)
    p0 = _flat(states[0].actor_params)
    for t in (1, 2):
        assert all(torch.equal(a, b) for a, b in
                   zip(_flat(states[t].actor_params), p0))
        assert any(not torch.equal(a, b) for a, b in zip(
            _flat(states[t].actor_params), _flat(states[t].learner.params)))
    assert all(torch.equal(a, b) for a, b in zip(
        _flat(states[3].actor_params), _flat(states[3].learner.params)))
    assert [s.t for s in states] == [0, 1, 2, 3]


def test_int8_cache_is_bitwise_stable_between_syncs():
    """Mirrors test_actor_learner.py::
    test_int8_cache_is_bitwise_stable_between_syncs."""
    states = _al_run("int8", 3, 3)
    cache0 = _flat(states[0].actor_cache)
    for t in (1, 2):
        assert states[t].actor_cache is states[0].actor_cache
    cache3 = _flat(states[3].actor_cache)
    assert any(not torch.equal(a, b) for a, b in zip(cache3, cache0))
    fresh = _flat(actorq.pack_actor_params(states[3].actor_params))
    assert all(torch.equal(a, b) for a, b in zip(cache3, fresh))
    assert all(torch.equal(a, b) for a, b in zip(
        cache3, _flat(actor_learner.remint_cache(states[3], "int8"))))
    assert actor_learner.remint_cache(_al_run("fp32", 1, 1)[1],
                                      "fp32") == ()
    swapped = actor_learner.with_cache(states[3], states[0].actor_cache)
    assert swapped.actor_cache is states[0].actor_cache
    assert swapped.actor_params is states[3].actor_params


def test_divergence_recorded_only_at_true_pushes():
    """Mirrors test_actor_learner.py::
    test_divergence_recorded_only_at_true_pushes: record points at 2, 4,
    6, 8 and pushes at 4, 8, so the pre-push point is skipped."""
    res = loops.train("dqn", "cartpole", topology="actor-learner",
                      num_actors=2, sync_every=4, actor_backend="int8",
                      iterations=8, record_every=2, eval_episodes=2, seed=3,
                      algo_overrides=dict(SMALL_DQN), device="cpu")
    assert len(res.divergences) == 3
    assert all(any(v > 0 for v in d) for d in res.divergences)


def test_fp32_divergence_is_pure_staleness():
    """Mirrors test_actor_learner.py::test_fp32_divergence_is_pure_staleness
    and test_async_actor_learner.py::test_async_fp32_divergence_is_zero_at_
    push: a push hands fp32 actors the learner's head itself."""
    for topo in (dict(topology="actor-learner", sync_every=1),
                 dict(topology="async", sync_every=2)):
        res = loops.train("dqn", "cartpole", num_actors=2, iterations=4,
                          record_every=2, eval_episodes=2, seed=0,
                          algo_overrides=dict(SMALL_DQN), device="cpu",
                          **topo)
        assert res.divergences
        assert all(v == 0.0 for d in res.divergences for v in d)


def test_multi_actor_int8_trains_finite():
    """Mirrors test_actor_learner.py::
    test_multi_actor_int8_trains_finite[dqn-cartpole]."""
    res = loops.train("dqn", "cartpole", topology="actor-learner",
                      num_actors=2, sync_every=2, actor_backend="int8",
                      iterations=4, record_every=2, eval_episodes=2, seed=3,
                      algo_overrides=dict(SMALL_DQN), device="cpu")
    assert all(np.isfinite(res.rewards))
    assert len(res.divergences) == 2
    assert all(len(d) == 2 and np.isfinite(d).all()
               for d in res.divergences)
    assert any(v > 0 for d in res.divergences for v in d)
    assert res.state.extras.replay.data.reward.shape == (2, 256)


# ---------------------------------------------------------------------------
# the async topology
# ---------------------------------------------------------------------------

def test_async_int8_trains_finite_with_staleness_metrics():
    """Mirrors test_async_actor_learner.py::
    test_async_int8_trains_finite_with_staleness_metrics[dqn-cartpole]."""
    res = loops.train("dqn", "cartpole", topology="async", num_actors=2,
                      sync_every=4, steps_per_call=2, actor_backend="int8",
                      iterations=8, record_every=4, eval_episodes=2, seed=3,
                      algo_overrides=dict(SMALL_DQN), device="cpu")
    assert all(np.isfinite(res.rewards))
    assert len(res.divergences) == len(res.actor_lags) == 4
    assert all(len(d) == 2 and np.isfinite(d).all()
               for d in res.divergences)
    assert any(v > 0 for d in res.divergences for v in d)
    assert all(lag == 4 for lag in res.actor_lags)
    assert int(res.state.extras.updates) > 0


def test_async_actor_lag_counts_updates_served():
    """Mirrors test_async_actor_learner.py's staleness contract in
    learner updates: rounds of 2 updates against a push every 3 give
    pushes every second round, each snapshot serving 4 updates."""
    res = loops.train("dqn", "cartpole", topology="async", num_actors=2,
                      sync_every=3, steps_per_call=1, iterations=8,
                      record_every=4, eval_episodes=2, seed=1,
                      algo_overrides=dict(SMALL_DQN), device="cpu")
    assert res.actor_lags == [4, 4, 4, 4]


def test_async_learner_consumes_double_buffered_data():
    """Mirrors test_async_actor_learner.py::
    test_async_learner_consumes_double_buffered_data."""
    res = loops.train("dqn", "cartpole", topology="async", num_actors=2,
                      sync_every=2, steps_per_call=1, iterations=8,
                      record_every=4, eval_episodes=2, seed=5,
                      algo_overrides=dict(SMALL_DQN), device="cpu")
    assert int(rb.replay_total_size(res.state.extras.replay)) > 0
    assert int(res.state.extras.updates) > 0
    assert res.state.extras.replay.data.reward.shape == (2, 128)


def test_async_swap_and_slots():
    """Mirrors test_async_actor_learner.py::
    test_async_round_dispatch_returns_futures on the CPU: a round writes
    the write slot only, the swap trades the slots by reference, and the
    learner then samples what the actors wrote."""
    env, net = _cartpole()
    cfg = _small_cfg(actor_backend="int8")
    al = actor_learner.ActorLearnerConfig(num_actors=2, sync_every=4)
    progs = actor_learner.make_async_actor_learner("dqn", env, net, cfg, al,
                                                   device="cpu")
    learner, wbuf = actor_learner.init_async(
        torch.Generator().manual_seed(0), env, net, "dqn", cfg, al)
    env_state, obs = progs.benv_global.reset(
        torch.Generator().manual_seed(1), "cpu")
    snap = progs.make_snapshot(learner, obs)
    gen = torch.Generator().manual_seed(2)
    read = learner.extras.replay
    env_state, obs, wbuf, a_m = progs.actor_chunk(snap, env_state, obs,
                                                  wbuf, gen, n_chunks=2)
    learner, l_m = progs.learner_chunk(learner, gen, n_updates=4)
    assert int(rb.replay_total_size(wbuf)) == 2 * 2 * 4 * 4
    assert int(rb.replay_total_size(learner.extras.replay)) == 0
    learner, wbuf2 = actor_learner.swap_read_slot(learner, wbuf)
    assert learner.extras.replay is wbuf and wbuf2.size is read.size
    snap = progs.make_snapshot(learner, obs)
    div = progs.divergence(learner, snap, obs)
    assert tuple(div.shape) == (2,) and bool(torch.isfinite(div).all())
    assert bool(torch.isfinite(a_m["reward"])) and bool(
        torch.isfinite(l_m["loss"]))
    assert not progs.streams.cuda


@pytest.mark.parametrize("name,topo,backend,calib", [
    ("al_int8", dict(topology="actor-learner", sync_every=2), "int8", 0),
    ("async_int4", dict(topology="async", sync_every=4, steps_per_call=2),
     "int4", 8)])
def test_topology_kernel_calls_match_chip_smoke(monkeypatch, name, topo,
                                                backend, calib):
    """Mirrors test_torch_train.py::test_actorq_train_runs_the_fused_actor
    for the topologies: B1 and B2 are called as often as chip_smoke.py
    holds their launches to (3 B1 a behaviour, eval or divergence head
    step uncalibrated; calibrated, one B2 there and 2 B1 a calibration at
    the first mint, every push and every eval mint)."""
    calls = {"int8_matmul": 0, "fused_qmlp": 0}

    def counting(name, real):
        def op(*a, **k):
            calls[name] += 1
            return real(*a, **k)
        return op
    for op in calls:
        monkeypatch.setattr(ops, op, counting(op, getattr(ops, op)))
    it = 6
    res = loops.train("dqn", "cartpole", num_actors=2, actor_backend=backend,
                      calib_batch=calib, iterations=it, record_every=3,
                      eval_episodes=2, seed=0, algo_overrides=dict(SMALL_DQN),
                      device="cpu", **topo)
    steps, records = it * SMALL_DQN["rollout_steps"], len(res.rewards)
    pushes = len(res.actor_lags) if res.actor_lags else it // 2
    heads = 2 * pushes
    if calib:
        want = {"fused_qmlp": steps + res.eval_steps + heads,
                "int8_matmul": 2 * (1 + pushes + records)}
    else:
        want = {"int8_matmul": 3 * (steps + res.eval_steps + heads),
                "fused_qmlp": 0}
    assert calls == want


# ---------------------------------------------------------------------------
# rejections
# ---------------------------------------------------------------------------

def test_actor_learner_rejects_invalid_configs():
    """Mirrors test_actor_learner.py::
    test_actor_learner_rejects_on_policy_algos."""
    kw = dict(iterations=2, device="cpu")
    with pytest.raises(ValueError):
        loops.train("ppo", "cartpole", topology="actor-learner", **kw)
    with pytest.raises(ValueError):
        loops.train("dqn", "cartpole", topology="ring", **kw)
    with pytest.raises(ValueError):
        loops.train("dqn", "cartpole", num_actors=4, **kw)
    with pytest.raises(ValueError):
        loops.train("dqn", "cartpole", topology="actor-learner",
                    num_actors=3, algo_overrides=dict(SMALL_DQN), **kw)
    with pytest.raises(ValueError, match="batch_size"):
        actor_learner.make_actor_learner(
            "dqn", *_cartpole(), _small_cfg(buffer_size=510),
            actor_learner.ActorLearnerConfig(num_actors=3), device="cpu")
    with pytest.raises(ValueError, match="sync_every"):
        loops.train("dqn", "cartpole", topology="actor-learner",
                    sync_every=0, algo_overrides=dict(SMALL_DQN), **kw)
    with pytest.raises(ValueError, match="QAT"):
        from repro_torch.core.qconfig import QuantConfig
        loops.train("dqn", "cartpole", topology="actor-learner",
                    quant=QuantConfig.qat(8), **kw)
    with pytest.raises(ValueError, match="priority_exponent"):
        loops.train("dqn", "cartpole", topology="actor-learner",
                    replay="prioritized", priority_exponent=-1.0, **kw)


def test_async_rejects_invalid_configs():
    """Mirrors test_async_actor_learner.py::test_async_rejects_invalid_
    configs."""
    kw = dict(iterations=2, device="cpu")
    with pytest.raises(ValueError):
        loops.train("ppo", "cartpole", topology="async", **kw)
    with pytest.raises(ValueError):
        loops.train("dqn", "cartpole", async_barrier=True, **kw)
    with pytest.raises(ValueError):
        loops.train("dqn", "cartpole", topology="actor-learner",
                    async_barrier=True, algo_overrides=dict(SMALL_DQN), **kw)
    with pytest.raises(ValueError):
        loops.train("dqn", "cartpole", topology="async", num_actors=3,
                    algo_overrides=dict(SMALL_DQN), **kw)
    with pytest.raises(ValueError, match="double-buffered"):
        loops.train("dqn", "cartpole", topology="async", num_actors=2,
                    algo_overrides=dict(SMALL_DQN, buffer_size=510), **kw)


def test_unported_topology_options_raise():
    """A mesh (item 14; for DDPG too, whose topologies are ported) still
    raises in the topologies; the resilience hooks (item 11) are ported,
    so a real context runs there as the reference's does; checkpointing
    is ported, and its knobs are validated as the reference's."""
    kw = dict(iterations=2, device="cpu", num_actors=2)
    for topo in ("actor-learner", "async"):
        with pytest.raises(NotImplementedError, match="item 14"):
            loops.train("ddpg", "pendulum", topology=topo, mesh=object(),
                        **kw)
        with pytest.raises(NotImplementedError, match="item 14"):
            loops.train("dqn", "cartpole", topology=topo, mesh=object(),
                        **kw)
        ctx = ResilienceContext()
        assert loops.train("dqn", "cartpole", topology=topo,
                           algo_overrides=dict(SMALL_DQN), resilience=ctx,
                           **kw).rewards
        assert ctx.events == [] and ctx.quarantined == []
        for extra in (dict(resume=True), dict(checkpoint_every=3)):
            with pytest.raises(ValueError, match="needs checkpoint_dir"):
                loops.train("dqn", "cartpole", topology=topo, **kw, **extra)
    with pytest.raises(NotImplementedError, match="item 14"):
        actor_learner.make_async_actor_learner(
            "dqn", *_cartpole(), _small_cfg(),
            actor_learner.ActorLearnerConfig(), mesh=object(), device="cpu")


# ---------------------------------------------------------------------------
# the divergence head against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend,calib", [("fp32", 0), ("int8", 0),
                                           ("int4", 0), ("int4", 16)])
def test_divergence_matches_jax(monkeypatch, backend, calib):
    """Mirrors test_actor_learner.py::test_multi_actor_int8_trains_finite's
    divergence record: ``_make_divergence`` on the same learner, actor
    params and observations is JAX's within 1e-5 (5e-3 for a logged code
    flip, ROADMAP queue C), and a quantized head quantizes each actor's
    observations on their own, bitwise JAX's per-actor codes and scale."""
    n, e = 4, 8
    jenv, jnet = jmake("cartpole"), jmake_network((4,), 2)
    jcfg = jdqn.DQNConfig(actor_backend=backend, calib_batch=calib,
                          kernel_backend="ref")
    jlearner = jdqn.init(jax.random.PRNGKey(3), jenv, jnet, jcfg)
    rng = np.random.default_rng(5)
    jactor = jax.tree_util.tree_map(
        lambda a: a + jnp.asarray(rng.normal(size=a.shape) * 0.05,
                                  jnp.float32), jlearner.params)
    # actors see different scales, so per-actor and folded scales differ
    obs = (rng.normal(size=(n * e, 4)) * np.repeat(
        [0.1, 0.5, 1.0, 2.0], e)[:, None]).astype(np.float32)
    jcache = ()
    if backend != "fp32":
        jcache = jactorq.make_actor_cache(
            jactor, backend, calib_obs=jnp.asarray(obs[:calib])
            if calib else None, backend="ref")
    jparts = jal._algo_parts("dqn", jenv, jnet, jcfg)
    jdiv = jal._make_divergence(jparts, backend != "fp32", n, e, (4,))
    want = np.asarray(jdiv(jlearner, jactor, jcache, jnp.asarray(obs)))

    env, net = _cartpole()
    cfg = dqn.DQNConfig(actor_backend=backend, calib_batch=calib)
    learner = common.state_from_jax(
        jax.tree_util.tree_map(np.asarray, jlearner), "cpu")
    actor = networks.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jactor), "cpu")
    cache = () if backend == "fp32" else actorq.make_actor_cache(
        actor, backend, calib_obs=torch.from_numpy(obs[:calib])
        if calib else None)
    seen = []
    real = ops.int8_matmul

    def recording(x_q, w_q, x_scale, x_zero, *args, **kw):
        seen.append((x_q.clone(), x_scale.clone(), x_zero.clone()))
        return real(x_q, w_q, x_scale, x_zero, *args, **kw)
    monkeypatch.setattr(ops, "int8_matmul", recording)
    div = actor_learner._make_divergence(
        actor_learner._algo_parts("dqn", env, net, cfg), backend != "fp32",
        n, e, (4,))
    got = div(learner, actor, cache, torch.from_numpy(obs)).numpy()
    diff = float(np.abs(got - want).max())
    if diff > 1e-5:
        print(f"divergence {backend} calib {calib}: a code flip moves it "
              f"by {diff:.3g}")
    assert diff <= 5e-3
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=5e-3)
    if backend != "fp32" and not calib:
        # the first layer of each actor's head: its own codes and scale
        firsts = seen[::3]
        assert len(firsts) == n
        for a, (x_q, scale, zero) in enumerate(firsts):
            jq, jp = jaffine.quantize_to_int(jnp.asarray(obs[a * e:(a + 1)
                                                             * e]), 8)
            np.testing.assert_array_equal(x_q.numpy(), np.asarray(jq))
            np.testing.assert_array_equal(scale.numpy().reshape(()),
                                          np.asarray(jp.delta).reshape(()))
            np.testing.assert_array_equal(zero.numpy().reshape(()),
                                          np.asarray(jp.zero_point)
                                          .reshape(()))
        # the widest actor sets the folded range; the others differ
        _, folded = affine.quantize_to_int(torch.from_numpy(obs), 8)
        assert sum(torch.equal(s.reshape(()), folded.delta.reshape(()))
                   for _, s, _ in firsts) == 1
