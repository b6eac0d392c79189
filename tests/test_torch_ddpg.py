"""Port parity: DDPG (``repro_torch.rl.ddpg``) against the JAX package,
and its contracts inside the port.

Tolerances, each with its reason:

* One DDPG update from the same JAX state and batch: the actor and
  critic params, both target nets, both Adam states, the observers,
  ``updates``, the loss and ``|td|`` within 1e-5.  The forward and
  backward matmuls sum in another order (an ulp), which Adam's
  normalised step carries on; with QAT on, an activation code may flip
  (ROADMAP queue C).
* The mu head ``tanh(quantized_apply)`` of an int8 / int4 cache packed
  from the same params: within 1e-6 of JAX's (``tanh`` and the epilogue
  in another library).
* ``soft_update``: bitwise (one multiply-add a leaf, the same order).
* Inside the port, bitwise: ``steps_per_call`` chunks are the per-step
  driver; actor-learner with one actor is the fused driver; async in
  barrier mode is actor-learner; ``priority_exponent=0`` is uniform.

Whole runs are held to finite rewards and exact kernel-call counts, not
to JAX's trajectories (``torch.Generator`` is not JAX's threefry).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fake_quant as jfq
from repro.core.qconfig import QuantConfig as JQuantConfig
from repro.rl import actor_learner as jal
from repro.rl import actorq as jactorq
from repro.rl import buffer as jrb
from repro.rl import common as jcommon
from repro.rl import ddpg as jddpg
from repro.rl.envs import make as jmake
from repro_torch.core import ptq
from repro_torch.core.qconfig import QuantConfig
from repro_torch.kernels import ops
from repro_torch.rl import actor_learner, actorq, common, ddpg, loops
from repro_torch.rl import buffer as rb
from repro_torch.rl import networks
from repro_torch.rl.envs import make

# tests/test_prioritized_replay.py:32
SMALL_DDPG = dict(n_envs=4, rollout_steps=4, updates_per_iter=2,
                  buffer_size=512, batch_size=16, warmup=8)
RUN = dict(iterations=6, record_every=3, eval_episodes=2,
           algo_overrides=dict(SMALL_DDPG), device="cpu")
# the parity state: a replay of 1024, a batch of 64, warm past 256
PARITY = dict(buffer_size=1024, batch_size=64, warmup=256)


def _flat(tree):
    return [t for _, t in ptq.tree_tensors(tree)]


def _transitions(rng, n):
    return (rng.normal(size=(n, 3)).astype(np.float32),
            rng.uniform(-2.0, 2.0, size=(n, 1)).astype(np.float32),
            rng.normal(size=n).astype(np.float32) - 4.0,
            (rng.uniform(size=n) < 0.1).astype(np.float32),
            rng.normal(size=(n, 3)).astype(np.float32))


def _jax_state(quant, replay, step, fill, seed):
    """A JAX DDPG state on Pendulum with a filled replay, perturbed
    targets, non-zero Adam moments for both nets and, for QAT, observers
    from a monitoring forward of the actor and the critic."""
    rng = np.random.default_rng(seed)
    jenv = jmake("pendulum")
    jnets = jddpg.make_nets(jenv)
    jcfg = jddpg.DDPGConfig(quant=JQuantConfig.parse(quant), replay=replay,
                            **PARITY)
    st = jddpg.init(jax.random.PRNGKey(seed), jenv, jnets, jcfg)
    tr = _transitions(rng, fill)
    add = jrb.per_add if replay == "prioritized" else jrb.replay_add_batch
    replay_st = add(st.extras.replay,
                    jrb.Transition(*(jnp.asarray(x) for x in tr)))

    def jitter(tree, scale):
        return jax.tree_util.tree_map(
            lambda a: a + jnp.asarray(rng.normal(size=a.shape) * scale,
                                      jnp.float32), tree)

    def moments(tree, scale):
        return jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.abs(rng.normal(size=a.shape)) * scale,
                                  jnp.float32), tree)

    def opt(o, tree):
        return o._replace(step=jnp.asarray(10, jnp.int32),
                          m=moments(tree, 1e-2), v=moments(tree, 1e-3))
    ex = st.extras
    # weights away from init, so the critic's output layer matters
    params = jitter(st.params, 0.1)
    critic = jitter(ex.critic_params, 0.1)
    observers = {}
    if jcfg.quant.is_qat:
        ctx = jfq.make_context(jcfg.quant, {}, 0)
        a = jnp.tanh(jnets.actor.apply(jcommon.PrefixCtx(ctx, "actor/"),
                                       params, jnp.asarray(tr[0])))
        jnets.critic.apply(jcommon.PrefixCtx(ctx, "critic/"), critic,
                           jnp.concatenate([jnp.asarray(tr[0]), a], -1))
        observers = ctx.merged_collection()
    st = st._replace(
        params=params, opt=opt(st.opt, params), observers=observers,
        step=jnp.asarray(step, jnp.int32),
        extras=ex._replace(critic_params=critic,
                           target_actor=jitter(params, 0.01),
                           target_critic=jitter(critic, 0.01),
                           critic_opt=opt(ex.critic_opt, critic),
                           replay=replay_st,
                           updates=jnp.asarray(40, jnp.int32)))
    return jenv, jnets, jcfg, st, rng


def _port(jst):
    return common.state_from_jax(jax.tree_util.tree_map(np.asarray, jst),
                                 "cpu")


def _pendulum(**cfg):
    env = make("pendulum")
    return env, ddpg.make_nets(env, device="cpu"), ddpg.DDPGConfig(**cfg)


def _close(got_tree, want_tree, atol=1e-5):
    got, want = _flat(got_tree), jax.tree_util.tree_leaves(want_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=atol)


# ---------------------------------------------------------------------------
# the update, from a JAX state carried across
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant,replay,step,fill", [
    ("none", "uniform", 0, 600),              # warm: both nets learn
    ("none", "uniform", 0, 100),              # warmup: the moments move
    ("none", "prioritized", 0, 600),          # IS weights on the critic
    ("qat8:delay=200", "uniform", 150, 600),  # QAT, monitoring
    ("qat8:delay=200", "uniform", 250, 600),  # QAT, quantized
])
def test_ddpg_update_matches_jax(quant, replay, step, fill):
    jenv, jnets, jcfg, jst, rng = _jax_state(quant, replay, step, fill,
                                             seed=step + fill)
    per = replay == "prioritized"
    data = jst.extras.replay.replay.data if per else jst.extras.replay.data
    size = jst.extras.replay.replay.size if per else jst.extras.replay.size
    idx = rng.integers(0, fill, size=64)
    w = rng.uniform(0.2, 1.0, size=64).astype(np.float32) if per else None
    jbatch = jax.tree_util.tree_map(lambda b: b[idx], data)
    jnew, (jloss, jtd) = jddpg.make_update(jenv, jnets, jcfg)(
        jst, jbatch, size, weights=None if w is None else jnp.asarray(w))

    st = _port(jst)
    env, nets, cfg = _pendulum(quant=QuantConfig.parse(quant), replay=replay,
                               **PARITY)
    pdata = st.extras.replay.replay.data if per else st.extras.replay.data
    batch = rb.Transition(*(b[torch.from_numpy(idx)] for b in pdata))
    new, (loss, td) = ddpg.make_update(env, nets, cfg)(
        st, batch, torch.tensor(fill, dtype=torch.int32),
        weights=None if w is None else torch.from_numpy(w))

    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(td.numpy(), np.asarray(jtd), rtol=1e-5,
                               atol=1e-5)
    ex, jex = new.extras, jnew.extras
    for got, want in ((new.params, jnew.params),
                      (ex.critic_params, jex.critic_params),
                      (ex.target_actor, jex.target_actor),
                      (ex.target_critic, jex.target_critic),
                      (new.opt.m, jnew.opt.m), (new.opt.v, jnew.opt.v),
                      (ex.critic_opt.m, jex.critic_opt.m),
                      (ex.critic_opt.v, jex.critic_opt.v)):
        _close(got, want)
    assert int(new.step) == int(jnew.step) == step + 1
    assert int(ex.updates) == int(jex.updates) == 40 + (fill >= 256)
    assert int(new.opt.step) == int(ex.critic_opt.step) == 11
    assert sorted(new.observers) == sorted(jnew.observers)
    for k, o in new.observers.items():
        for got, want in zip(o, jnew.observers[k]):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6)
    if quant != "none":
        # actor sites from the actor step, critic sites from the critic
        # step: the observers thread critic -> actor
        assert {k.split("/")[0] for k in new.observers} == {"actor",
                                                            "critic"}
    if fill < 256:
        # warmup holds the params and the count, not Adam's moments
        for a, b in ((new.params, st.params),
                     (ex.critic_params, st.extras.critic_params)):
            for x, y in zip(_flat(a), _flat(b)):
                assert torch.equal(x, y)
        assert not all(torch.equal(x, y) for x, y in zip(
            _flat(new.opt.m), _flat(st.opt.m)))


def test_td_target_takes_the_unscaled_target_action():
    """The reference's TD target feeds the target critic the target
    actor's raw ``tanh`` (``src/repro/rl/ddpg.py:179-181``), not the
    ``action_scale``-times action the replay stores and the actor loss
    feeds it (``:139``, ``:202-204``); Pendulum's scale is 2.  The port
    keeps it (ROADMAP queue C): its ``|td|`` is the unscaled target's,
    and JAX's (``test_ddpg_update_matches_jax``)."""
    _, _, _, jst, rng = _jax_state("none", "uniform", 0, 600, seed=1)
    st = _port(jst)
    env, nets, cfg = _pendulum(**PARITY)
    assert env.spec.action_scale == 2.0
    idx = torch.from_numpy(rng.integers(0, 600, size=64))
    batch = rb.Transition(*(b[idx] for b in st.extras.replay.data))
    _, (_, td) = ddpg.make_update(env, nets, cfg)(
        st, batch, st.extras.replay.size)
    ex = st.extras

    def td_with(scale):
        a = torch.tanh(nets.actor.apply(ex.target_actor, batch.next_obs))
        q_next = nets.critic.apply(ex.target_critic, torch.cat(
            [batch.next_obs, a * scale], -1))[..., 0]
        target = batch.reward + cfg.gamma * (1 - batch.done) * q_next
        q = nets.critic.apply(ex.critic_params, torch.cat(
            [batch.obs, batch.action], -1))[..., 0]
        return (q - target).abs()
    np.testing.assert_allclose(td.numpy(), td_with(1.0).numpy(), rtol=1e-6,
                               atol=1e-6)
    assert float((td - td_with(env.spec.action_scale)).abs().max()) > 1e-4


@pytest.mark.parametrize("replay,sharded", [("uniform", False),
                                            ("prioritized", False),
                                            ("uniform", True),
                                            ("prioritized", True)])
def test_state_from_jax_carries_ddpg_extras(replay, sharded):
    jenv = jmake("pendulum")
    jnets = jddpg.make_nets(jenv)
    jcfg = jddpg.DDPGConfig(replay=replay, buffer_size=64)
    if sharded:
        jst = jal.init(jax.random.PRNGKey(0), jenv, jnets, "ddpg", jcfg,
                       jal.ActorLearnerConfig(num_actors=2)).learner
    else:
        jst = jddpg.init(jax.random.PRNGKey(0), jenv, jnets, jcfg)
    st = _port(jst)
    assert isinstance(st.extras, ddpg.DDPGExtras)
    got = _flat(st)
    want = jax.tree_util.tree_leaves(jst)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.from_numpy(np.array(w)).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    data = st.extras.replay.replay.data if replay == "prioritized" \
        else st.extras.replay.data
    assert data.action.dtype == torch.float32
    assert tuple(data.action.shape[-1:]) == (1,)


# ---------------------------------------------------------------------------
# the behaviour head and soft_update
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend,calib", [("int8", 0), ("int4", 0),
                                           ("int4", 16), ("fp32", 0)])
def test_mu_head_matches_jax(backend, calib):
    """The actors' head of the topologies (``_algo_parts("ddpg")``):
    ``tanh(quantized_apply)`` on a cache packed (and calibrated) from the
    same params, or the fp32 ``tanh(actor)``, within 1e-6 of JAX's."""
    rng = np.random.default_rng(2)
    jenv = jmake("pendulum")
    jnets = jddpg.make_nets(jenv)
    jcfg = jddpg.DDPGConfig(actor_backend=backend, calib_batch=calib,
                            kernel_backend="ref")
    jparams = jax.tree_util.tree_map(
        lambda a: a * 20.0, jnets.actor.init(jax.random.PRNGKey(4)))
    obs = (rng.normal(size=(32, 3)) * 2).astype(np.float32)
    jparts = jal._algo_parts("ddpg", jenv, jnets, jcfg)
    env, nets, cfg = _pendulum(actor_backend=backend, calib_batch=calib)
    parts = actor_learner._algo_parts("ddpg", env, nets, cfg)
    params = networks.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    if backend == "fp32":
        want = jparts.fp32_head(jparams, jnp.asarray(obs), {}, 0)
        got = parts.fp32_head(params, torch.from_numpy(obs), {},
                              torch.tensor(0))
    else:
        jcache = jactorq.make_actor_cache(
            jparams, backend, calib_obs=jnp.asarray(obs[:calib])
            if calib else None, backend="ref")
        cache = actorq.make_actor_cache(
            params, backend, calib_obs=torch.from_numpy(obs[:calib])
            if calib else None)
        want = jparts.cache_head(jcache, jnp.asarray(obs))
        got = parts.cache_head(cache, torch.from_numpy(obs))
    assert tuple(got.shape) == (32, 1)
    assert float(got.abs().max()) > 0.1          # not all near zero
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    act = parts.act_fn(params, torch.from_numpy(obs))
    np.testing.assert_allclose(
        act.numpy(), np.asarray(jparts.act_fn(jparams, jnp.asarray(obs))),
        rtol=1e-6, atol=1e-6)


def test_soft_update_is_bitwise_jax():
    rng = np.random.default_rng(3)
    shapes = {"fc0": {"w": (3, 64), "b": (64,)}, "out": {"w": (64, 1),
                                                         "b": (1,)}}
    t, o = ({k: {n: rng.normal(size=s).astype(np.float32)
                 for n, s in v.items()} for k, v in shapes.items()}
            for _ in range(2))
    got = common.soft_update(ptq.tree_map(torch.from_numpy, t),
                             ptq.tree_map(torch.from_numpy, o), 0.01)
    want = jcommon.soft_update(jax.tree_util.tree_map(jnp.asarray, t),
                               jax.tree_util.tree_map(jnp.asarray, o), 0.01)
    for g, w in zip(_flat(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# contracts inside the port (bitwise)
# ---------------------------------------------------------------------------

def _assert_same_run(a, b):
    """Equal rewards and learner states, bit for bit (the replays, sharded
    in one topology and not in the other, aside)."""
    assert a.rewards == b.rewards

    def learner(st):
        return (st.params, st.opt, st.observers, st.step,
                st.extras._replace(replay=()))
    x, y = _flat(learner(a.state)), _flat(learner(b.state))
    assert len(x) == len(y)
    for u, v in zip(x, y):
        assert torch.equal(u, v)


def test_steps_per_call_is_bitwise_the_per_step_driver():
    """Mirrors test_actorq.py::test_scan_fused_driver_bitwise_equivalent
    for DDPG (QAT on, prioritized replay)."""
    kw = dict(RUN, seed=3, quant=QuantConfig.qat(8, quant_delay=4),
              replay="prioritized")
    _assert_same_run(loops.train("ddpg", "pendulum", steps_per_call=1, **kw),
                     loops.train("ddpg", "pendulum", steps_per_call=5, **kw))


@pytest.mark.parametrize("backend", ["fp32", "int8"])
def test_single_actor_parity_with_fused_ddpg(backend):
    """Mirrors test_actor_learner.py::
    test_single_actor_parity_with_fused_dqn for DDPG."""
    kw = dict(RUN, seed=7, actor_backend=backend)
    fused = loops.train("ddpg", "pendulum", **kw)
    al = loops.train("ddpg", "pendulum", topology="actor-learner",
                     num_actors=1, sync_every=1, **kw)
    assert al.divergences and fused.divergences == []
    _assert_same_run(fused, al)


@pytest.mark.parametrize("backend", ["fp32", "int8"])
def test_async_barrier_anchor_matches_synchronous_ddpg(backend):
    """Mirrors test_async_actor_learner.py::
    test_async_barrier_anchor_matches_synchronous_driver for DDPG."""
    kw = dict(RUN, seed=7, actor_backend=backend)
    sync = loops.train("ddpg", "pendulum", topology="actor-learner",
                       num_actors=1, sync_every=1, **kw)
    anc = loops.train("ddpg", "pendulum", topology="async", num_actors=1,
                      sync_every=SMALL_DDPG["updates_per_iter"],
                      async_barrier=True, steps_per_call=1, **kw)
    assert anc.actor_lags == [SMALL_DDPG["updates_per_iter"]] * 6
    assert sync.divergences == anc.divergences[2::3]
    _assert_same_run(sync, anc)


@pytest.mark.parametrize("topo", [
    {}, dict(topology="actor-learner", num_actors=2, sync_every=2),
    dict(topology="async", num_actors=2, sync_every=4, steps_per_call=2)],
    ids=str)
def test_priority_exponent_zero_is_bitwise_uniform(topo):
    """Mirrors test_prioritized_replay.py::
    test_priority_exponent_zero_is_bitwise_uniform for DDPG."""
    kw = dict(RUN, seed=13, **topo)
    _assert_same_run(
        loops.train("ddpg", "pendulum", replay="uniform", **kw),
        loops.train("ddpg", "pendulum", replay="prioritized",
                    priority_exponent=0.0, **kw))


def test_ddpg_carries_learner_update_counter():
    """Mirrors test_prioritized_replay.py::
    test_ddpg_carries_learner_update_counter."""
    kw = dict(iterations=3, record_every=3, eval_episodes=2, seed=0,
              device="cpu")
    res = loops.train("ddpg", "pendulum",
                      algo_overrides=dict(SMALL_DDPG, warmup=10 ** 6), **kw)
    assert int(res.state.extras.updates) == 0
    assert int(res.state.step) == 3 * SMALL_DDPG["updates_per_iter"]
    res2 = loops.train("ddpg", "pendulum", algo_overrides=dict(SMALL_DDPG),
                       **kw)
    assert int(res2.state.extras.updates) \
        == 3 * SMALL_DDPG["updates_per_iter"]
    assert isinstance(res2.state.extras, ddpg.DDPGExtras)


# ---------------------------------------------------------------------------
# short runs and their kernel calls
# ---------------------------------------------------------------------------

def _count(monkeypatch):
    calls = {"int8_matmul": 0, "fused_qmlp": 0, "qat_activation_site": 0,
             "qat_weight_site": 0}

    def counting(name, real):
        def op(*a, **k):
            calls[name] += 1
            return real(*a, **k)
        return op
    for name in calls:
        monkeypatch.setattr(ops, name, counting(name, getattr(ops, name)))
    return calls


@pytest.mark.parametrize("run,kw", [
    ("fp32", {}), ("int8", dict(actor_backend="int8")),
    ("int4", dict(actor_backend="int4", calib_batch=4)),
    ("qat8", dict(quant=QuantConfig.qat(8, quant_delay=4))),
    ("al_int8", dict(topology="actor-learner", num_actors=2, sync_every=2,
                     actor_backend="int8")),
    ("async_int4", dict(topology="async", num_actors=2, sync_every=4,
                        steps_per_call=2, actor_backend="int4",
                        calib_batch=8))])
def test_short_runs_are_finite_with_exact_kernel_calls(monkeypatch, run, kw):
    """The counts ``chip_smoke.py`` holds the card's launches to: B1 3 a
    forward of the 2-hidden-layer actor (each behaviour step, eval step
    and divergence head), B2 once a calibrated forward and 2 B1 a
    calibration, B5 one a QAT site (6 a forward; an update runs 5: the
    target actor and critic, the critic, the actor and the critic on
    its actions)."""
    calls = _count(monkeypatch)
    it = 6
    res = loops.train("ddpg", "pendulum", **dict(RUN, seed=1, **kw))
    assert len(res.rewards) == 2 and all(np.isfinite(res.rewards))
    steps = it * SMALL_DDPG["rollout_steps"]
    updates = it * SMALL_DDPG["updates_per_iter"]
    records = len(res.rewards)
    want = dict.fromkeys(calls, 0)
    topo = kw.get("topology", "fused")
    pushes = len(res.actor_lags) if topo == "async" \
        else it // kw.get("sync_every", it + 1)
    heads = pushes * kw.get("num_actors", 1)
    if kw.get("calib_batch"):
        mints = (1 + pushes) if topo != "fused" else it
        want["fused_qmlp"] = steps + res.eval_steps + heads
        want["int8_matmul"] = 2 * (mints + records)
    elif kw.get("actor_backend") == "int8":
        want["int8_matmul"] = 3 * (steps + res.eval_steps + heads)
    if "quant" in kw:
        forwards = steps + res.eval_steps + 5 * updates
        want["qat_activation_site"] = want["qat_weight_site"] = 3 * forwards
        assert sorted(res.state.observers) == sorted(
            f"{net}/{layer}/out" for net in ("actor", "critic")
            for layer in ("fc0", "fc1", "out"))
    assert calls == want
    if topo != "fused":
        divs = np.asarray(res.divergences)
        assert divs.shape[1] == kw["num_actors"] and np.isfinite(divs).all()
        assert (divs > 0).any()


def test_eval_policy_and_quarl_pipelines_take_ddpg():
    """``eval_policy`` packs the actor only (the critic stays in the
    extras; tests/test_actorq.py:183-193); ``quarl_ptq`` and
    ``quarl_qat`` return their rows."""
    res = loops.train("ddpg", "pendulum", **dict(RUN, iterations=3))
    qp = actorq.pack_actor_params(res.state.params, 8)
    assert sorted(qp) == ["fc0", "fc1", "out"]
    r8 = loops.eval_policy(res, QuantConfig.ptq_int(8),
                           torch.Generator().manual_seed(0), 2,
                           actor_backend="int8")
    assert np.isfinite(r8)
    kw = dict(iterations=3, eval_episodes=2,
              algo_overrides=dict(SMALL_DDPG), device="cpu")
    rows = loops.quarl_ptq("ddpg", "pendulum", bits_list=(8, 16), **kw)
    assert [r.label for r in rows] == ["ptq_int8", "ptq_fp16"]
    assert all(np.isfinite(r.quant_reward) for r in rows)
    row = loops.quarl_qat("ddpg", "pendulum", 8, **kw)
    assert row.label == "qat8" and np.isfinite(row.quant_reward)


def test_ddpg_rejections():
    kw = dict(iterations=1, device="cpu")
    with pytest.raises(ValueError, match="continuous"):
        loops.train("ddpg", "cartpole", **kw)
    with pytest.raises(ValueError, match="kernel_backend"):
        ddpg.make_iteration(*_pendulum(kernel_backend="ref"), device="cpu")
    with pytest.raises(ValueError, match="QAT"):
        loops.train("ddpg", "pendulum", topology="async",
                    quant=QuantConfig.qat(8), **kw)
    # the reference's fields and defaults
    mine = {f.name: getattr(ddpg.DDPGConfig(), f.name)
            for f in dataclasses.fields(ddpg.DDPGConfig) if f.name != "quant"}
    assert mine == {f.name: getattr(jddpg.DDPGConfig(), f.name)
                    for f in dataclasses.fields(jddpg.DDPGConfig)
                    if f.name != "quant"}
