"""Port parity: the on-policy algorithms PPO and A2C
(``repro_torch.rl.ppo``, ``repro_torch.rl.a2c``) against the JAX
package, their contracts inside the port and the default launcher run.

The learners are held to JAX's on the same trajectory: the test swaps
the ``rollout`` that ``repro.rl.ppo`` / ``repro.rl.a2c`` import for one
that returns a numpy-made trajectory (no file of the JAX package
changes), draws JAX's permutations from the iteration's key as JAX
does, and hands both to the port's learner half.

Tolerances, each with its reason:

* ``gae``: within 1e-6 (the same float32 ops, in the same order).
* One A2C step, and one PPO iteration at ``epochs=1, n_minibatches=1``:
  params and Adam's moments within 1e-5 (the matmuls sum in another
  order, an ulp, which Adam's normalised step carries on).
* PPO at its defaults (4 epochs x 4 minibatches, 16 Adam steps on
  1,024 samples): within ``PPO_DEFAULT_ATOL`` = 1e-5 as well.  Measured
  on the CPU: the params within 6.0e-8 of JAX's (1.5e-8 at one
  minibatch), so 16 steps in a row stay far inside it.
* Inside the port, bitwise: ``steps_per_call`` chunks are the per-step
  driver.

Whole runs are held to finite rewards and exact kernel-call counts
(the convergence bars run on the card, ``chip_smoke.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.rl import a2c as ja2c
from repro.rl import actorq as jactorq
from repro.rl import env as jenv_mod
from repro.rl import ppo as jppo
from repro.rl.envs import make as jmake
from repro.rl.networks import make_network as jmake_network
from repro_torch.core import metrics, ptq
from repro_torch.core.qconfig import QuantConfig
from repro_torch.kernels import ops
from repro_torch.launch import train as launch_train
from repro_torch.rl import a2c, actorq, common, env as env_mod, loops, ppo
from repro_torch.rl import networks
from repro_torch.rl.envs import make

SMALL = dict(n_envs=4, n_steps=8)
RUN = dict(iterations=4, record_every=2, eval_episodes=2,
           algo_overrides=dict(SMALL), device="cpu")
PPO_DEFAULT_ATOL = 1e-5


def _flat(tree):
    return [t for _, t in ptq.tree_tensors(tree)]


def _close(got_tree, want_tree, atol):
    got, want = _flat(got_tree), jax.tree_util.tree_leaves(want_tree)
    assert len(got) == len(want)
    worst = 0.0
    for g, w in zip(got, want):
        worst = max(worst, float(np.abs(g.numpy() - np.asarray(w)).max()))
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=atol)
    return worst


def _trajectory(rng, t, b, params, logits_fn):
    """A numpy CartPole trajectory of ``t`` steps over ``b`` envs, with
    behaviour logits, values and log-probs near the params' own."""
    obs = rng.normal(size=(t, b, 4)).astype(np.float32) * 0.5
    logits = logits_fn(params, obs)
    action = rng.integers(0, 2, size=(t, b)).astype(np.int32)
    logz = np.log(np.exp(logits).sum(-1))
    logp = (np.take_along_axis(logits, action[..., None], -1)[..., 0] - logz
            + rng.normal(size=(t, b)) * 0.1).astype(np.float32)
    return dict(obs=obs, action=action,
                reward=np.ones((t, b), np.float32),
                done=(rng.uniform(size=(t, b)) < 0.1).astype(np.float32),
                next_obs=rng.normal(size=(t, b, 4)).astype(np.float32),
                logits=logits.astype(np.float32),
                value=rng.normal(size=(t, b)).astype(np.float32),
                logp=logp, last_obs=rng.normal(size=(b, 4)).astype(
                    np.float32) * 0.5)


def _jax_traj(tr, aux):
    return jenv_mod.StepOut(*(jnp.asarray(tr[k]) for k in (
        "obs", "action", "reward", "done", "next_obs")), aux)


def _port_traj(tr, aux):
    return env_mod.StepOut(*(torch.from_numpy(tr[k]) for k in (
        "obs", "action", "reward", "done", "next_obs")), aux)


def _run_jax(monkeypatch, module, cfg, tr, aux, seed):
    """One jitted JAX iteration whose rollout returns ``tr``; returns its
    state, metrics and key."""
    jenv = jmake("cartpole")
    jnet = jmake_network((4,), 3)
    state = module.init(jax.random.PRNGKey(seed), jenv, jnet, cfg)
    if cfg.quant.is_qat:            # the slots the scan carries need
        from repro.rl import loops as jloops
        state = state._replace(observers=jloops._bootstrap_observers(
            module.__name__.rsplit(".", 1)[1], jenv, jnet, state,
            cfg.quant))

    def fake_rollout(benv, policy, params, env_state, obs, key, n):
        return env_state, jnp.asarray(tr["last_obs"]), _jax_traj(tr, aux)
    monkeypatch.setattr(module, "rollout", fake_rollout)
    iteration, _, benv = module.make_iteration(jenv, jnet, cfg)
    key = jax.random.PRNGKey(seed + 100)
    env_state, obs = benv.reset(jax.random.PRNGKey(seed + 200))
    new, _, _, m = iteration(state, env_state, obs, key)
    return state, new, m, key


def _jax_logits(params):
    jnet = jmake_network((4,), 3)

    def logits(_, obs):
        from repro.core.fake_quant import NullQATContext
        return np.asarray(jnet.apply(NullQATContext(), params,
                                     jnp.asarray(obs)))[..., :2]
    return logits


# ---------------------------------------------------------------------------
# GAE and the learners against JAX
# ---------------------------------------------------------------------------

def test_gae_matches_jax():
    rng = np.random.default_rng(0)
    t, b = 64, 16
    r, v = (rng.normal(size=(t, b)).astype(np.float32) for _ in range(2))
    d = (rng.uniform(size=(t, b)) < 0.1).astype(np.float32)
    last = rng.normal(size=b).astype(np.float32)
    got = ppo.gae(*(torch.from_numpy(x) for x in (r, d, v, last)), 0.99,
                  0.95)
    want = jppo.gae(*(jnp.asarray(x) for x in (r, d, v, last)), 0.99, 0.95)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("overrides,atol", [
    (dict(epochs=1, n_minibatches=1), 1e-5),
    (dict(epochs=1, n_minibatches=1, quant="qat8:delay=0"), 1e-5),
    ({}, PPO_DEFAULT_ATOL)], ids=["one-minibatch", "qat8", "defaults"])
def test_ppo_learner_matches_jax(monkeypatch, overrides, atol):
    from repro.core.qconfig import QuantConfig as JQuantConfig
    overrides = dict(overrides)
    quant = overrides.pop("quant", "none")
    jcfg = jppo.PPOConfig(quant=JQuantConfig.parse(quant), **overrides)
    rng = np.random.default_rng(1)
    jstate0 = jppo.init(jax.random.PRNGKey(3), jmake("cartpole"),
                        jmake_network((4,), 3), jcfg)
    tr = _trajectory(rng, jcfg.n_steps, jcfg.n_envs, jstate0.params,
                     _jax_logits(jstate0.params))
    aux = (jnp.asarray(tr["logits"]), jnp.asarray(tr["value"]),
           jnp.asarray(tr["logp"]))
    jstate, jnew, jm, key = _run_jax(monkeypatch, jppo, jcfg, tr, aux, 3)
    # JAX's permutations, drawn as its iteration draws them
    _, k_perm = jax.random.split(key)
    n_data = jcfg.n_steps * jcfg.n_envs
    perms = [torch.from_numpy(np.array(jax.random.permutation(k, n_data)))
             for k in jax.random.split(k_perm, jcfg.epochs)]

    env = make("cartpole")
    net = networks.make_network((4,), 3, device="cpu")
    cfg = ppo.PPOConfig(quant=QuantConfig.parse(quant), **overrides)
    st = common.state_from_jax(jax.tree_util.tree_map(np.asarray, jstate),
                               "cpu")
    traj = _port_traj(tr, tuple(torch.from_numpy(tr[k])
                                for k in ("logits", "value", "logp")))
    heads = common.make_heads(net, cfg.quant, 2)
    last_value = heads(st.params, torch.from_numpy(tr["last_obs"]),
                       st.observers, st.step)[1]
    new, m = ppo.make_learner(env, net, cfg)(st, traj, last_value, perms)
    worst = _close(new.params, jnew.params, atol)
    _close(new.opt.m, jnew.opt.m, atol)
    _close(new.opt.v, jnew.opt.v, atol)
    print(f"PPO {overrides or 'defaults'} {quant}: params within "
          f"{worst:.3g} of JAX")
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5, atol=atol)
    np.testing.assert_allclose(float(m["action_dist_variance"]),
                               float(jm["action_dist_variance"]), rtol=1e-5)
    assert int(new.step) == int(jnew.step) == 1
    assert int(new.opt.step) == int(jnew.opt.step) \
        == jcfg.epochs * jcfg.n_minibatches
    assert sorted(new.observers) == sorted(jnew.observers)
    for k, o in new.observers.items():
        for got, want in zip(o, jnew.observers[k]):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6)


@pytest.mark.parametrize("quant", ["none", "qat8:delay=0"])
def test_a2c_learner_matches_jax(monkeypatch, quant):
    from repro.core.qconfig import QuantConfig as JQuantConfig
    jcfg = ja2c.A2CConfig(quant=JQuantConfig.parse(quant))
    rng = np.random.default_rng(2)
    jstate0 = ja2c.init(jax.random.PRNGKey(4), jmake("cartpole"),
                        jmake_network((4,), 3), jcfg)
    tr = _trajectory(rng, jcfg.n_steps, jcfg.n_envs, jstate0.params,
                     _jax_logits(jstate0.params))
    jstate, jnew, jm, _ = _run_jax(monkeypatch, ja2c, jcfg, tr,
                                   jnp.asarray(tr["logits"]), 4)
    env = make("cartpole")
    net = networks.make_network((4,), 3, device="cpu")
    cfg = a2c.A2CConfig(quant=QuantConfig.parse(quant))
    st = common.state_from_jax(jax.tree_util.tree_map(np.asarray, jstate),
                               "cpu")
    new, m = a2c.make_learner(env, net, cfg)(
        st, _port_traj(tr, torch.from_numpy(tr["logits"])),
        torch.from_numpy(tr["last_obs"]))
    for got, want in ((new.params, jnew.params), (new.opt.m, jnew.opt.m),
                      (new.opt.v, jnew.opt.v)):
        _close(got, want, 1e-5)
    for k in ("loss", "entropy", "action_dist_variance"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-6)
    assert int(new.step) == int(jnew.step) == 1
    assert sorted(new.observers) == sorted(jnew.observers)


def test_sampling_policy_and_metrics():
    """``make_sampling_policy`` keeps the packed head's logits (JAX's
    within 1e-5) and samples them by Gumbel-max: over 20,000 draws each
    action's frequency is its softmax probability within 0.02; the
    metrics are the reference's."""
    rng = np.random.default_rng(5)
    jnet = jmake_network((4,), 3)
    jparams = jax.tree_util.tree_map(
        lambda a: a * 30.0, jnet.init(jax.random.PRNGKey(6)))
    obs = rng.normal(size=(4, 4)).astype(np.float32)
    spec = make("cartpole").spec
    jq = jactorq.pack_actor_params(jparams, 8)
    _, jlogits = jactorq.make_sampling_policy(
        jmake("cartpole").spec, backend="ref")(jq, jnp.asarray(obs),
                                               jax.random.PRNGKey(0))
    q = actorq.pack_actor_params(networks.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu"), 8)
    policy = actorq.make_sampling_policy(spec)
    action, logits = policy(q, torch.from_numpy(obs),
                            torch.Generator().manual_seed(0))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-5, atol=1e-5)
    assert action.dtype == torch.int32 and tuple(action.shape) == (4,)
    big = logits[:1].expand(20_000, 2)
    draws = actorq.sample_categorical(big, torch.Generator().manual_seed(1))
    freq = torch.bincount(draws.long(), minlength=2).float() / 20_000
    np.testing.assert_allclose(freq.numpy(),
                               torch.softmax(logits[0], -1).numpy(),
                               atol=0.02)
    assert float(metrics.action_distribution_variance(logits)) == \
        pytest.approx(float(jnp.var(jax.nn.softmax(jlogits, -1), -1)
                            .mean()), rel=1e-5)
    assert metrics.ema([1.0, 0.0, 0.0], 0.5) == [1.0, 0.5, 0.25]
    w = {"fc0": {"w": torch.linspace(-1, 1, 64).reshape(4, 16),
                 "b": torch.zeros(16)}}
    from repro.core import metrics as jmetrics
    assert metrics.mean_int8_weight_error(w) == pytest.approx(
        jmetrics.mean_int8_weight_error(
            jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), w)),
        rel=1e-5)


# ---------------------------------------------------------------------------
# contracts inside the port, short runs and their kernel calls
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algo", ["a2c", "ppo"])
def test_steps_per_call_is_bitwise_the_per_step_driver(algo):
    """Mirrors test_actorq.py::test_scan_fused_driver_bitwise_equivalent."""
    kw = dict(RUN, seed=7, actor_backend="int8")
    a = loops.train(algo, "cartpole", steps_per_call=1, **kw)
    b = loops.train(algo, "cartpole", steps_per_call=3, **kw)
    assert a.rewards == b.rewards
    assert a.action_variances == b.action_variances
    for x, y in zip(_flat(a.state), _flat(b.state)):
        assert torch.equal(x, y)


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


@pytest.mark.parametrize("algo", ["a2c", "ppo"])
@pytest.mark.parametrize("run,kw", [
    ("fp32", {}), ("int8", dict(actor_backend="int8")),
    ("int4", dict(actor_backend="int4", calib_batch=4)),
    ("qat8", dict(quant=QuantConfig.qat(8, quant_delay=2)))])
def test_short_runs_are_finite_with_exact_kernel_calls(monkeypatch, algo,
                                                       run, kw):
    """The counts ``chip_smoke.py`` holds the card's launches to: B1 3 a
    forward of the 2-hidden-layer actor (PPO: ``n_steps`` and the
    bootstrap an iteration; A2C: ``n_steps``; and every eval step), B2
    once a calibrated forward and 2 B1 a calibration (every iteration
    and eval), B5 one a QAT site, 6 a forward (the behaviour steps, the
    learner's forwards -- A2C 2 an iteration, PPO one a minibatch -- and
    the eval steps)."""
    calls = _count(monkeypatch)
    res = loops.train(algo, "cartpole", seed=1, **dict(RUN, **kw))
    it, records = RUN["iterations"], len(res.rewards)
    assert records == 2 and all(np.isfinite(res.rewards))
    assert all(np.isfinite(res.action_variances))
    cfg = res.algo_cfg
    fwd = it * (cfg.n_steps + (1 if algo == "ppo" else 0))
    want = dict.fromkeys(calls, 0)
    if kw.get("calib_batch"):
        want["fused_qmlp"] = fwd + res.eval_steps
        want["int8_matmul"] = 2 * (it + records)
    elif kw.get("actor_backend") == "int8":
        want["int8_matmul"] = 3 * (fwd + res.eval_steps)
    if "quant" in kw:
        learner = 2 if algo == "a2c" else cfg.epochs * cfg.n_minibatches
        n = it * (cfg.n_steps + (1 if algo == "ppo" else 0) + learner) \
            + res.eval_steps
        want["qat_activation_site"] = want["qat_weight_site"] = 3 * n
        assert sorted(res.state.observers) == ["fc0/out", "fc1/out",
                                               "out/out"]
        assert int(res.state.step) == it
    assert calls == want


@pytest.mark.parametrize("algo", ["a2c", "ppo"])
def test_mountaincar_runs_finite(algo):
    """The two-feature observation (K = 2 at B1) and a 3-action head."""
    res = loops.train(algo, "mountaincar", actor_backend="int8",
                      **dict(RUN, iterations=2))
    assert all(np.isfinite(res.rewards))
    assert res.net.out_dim == 4


def test_on_policy_pipelines_and_rejections():
    kw = dict(iterations=2, eval_episodes=2, algo_overrides=dict(SMALL),
              device="cpu")
    rows = loops.quarl_ptq("ppo", "cartpole", bits_list=(8, 16), **kw)
    assert all(np.isfinite(r.quant_reward) for r in rows)
    row = loops.quarl_qat("a2c", "cartpole", 8, **kw)
    assert np.isfinite(row.quant_reward)
    assert len(row.extra["variances_qat"]) == 1
    with pytest.raises(ValueError, match="on-policy"):
        loops.train("ppo", "cartpole", replay="prioritized", **kw)
    with pytest.raises(ValueError, match="kernel_backend"):
        ppo.make_iteration(make("cartpole"), networks.make_network(
            (4,), 3, device="cpu"), ppo.PPOConfig(kernel_backend="ref"),
            device="cpu")
    for mine, ref in ((ppo.PPOConfig, jppo.PPOConfig),
                      (a2c.A2CConfig, ja2c.A2CConfig)):
        assert {f.name: getattr(mine(), f.name)
                for f in dataclasses.fields(mine) if f.name != "quant"} \
            == {f.name: getattr(ref(), f.name)
                for f in dataclasses.fields(ref) if f.name != "quant"}


def test_launch_train_defaults_on_cpu(capsys):
    """``python -m repro_torch.launch.train``'s defaults (PPO on CartPole),
    cut to 2 iterations, and DDPG on Pendulum with an int8 actor."""
    assert launch_train.main(["--device", "cpu", "--iterations", "2"]) == 0
    out = capsys.readouterr().out
    assert "ppo on cartpole" in out and "actor=fp32" in out
    assert launch_train.main(["--device", "cpu", "--iterations", "2",
                              "--algo", "ddpg", "--env", "pendulum",
                              "--actor-backend", "int8"]) == 0
    assert "ddpg on pendulum" in capsys.readouterr().out
