"""Port parity and contracts: DQN with the paper's conv actor on pixel
Catch (``rl.dqn``, ``rl.loops``, ``rl.actor_learner`` and
``launch.train`` over the conv net of ``rl.networks``).

* One TD update on a conv net from the same JAX state, batch, observers
  and step, fp32 and QAT (monitoring, and past the delay): loss, params,
  target and Adam's moments within 1e-5 of the JAX package's (the
  convolutions and matmuls sum in another order, which Adam's normalised
  step carries on), observers within 1e-6 relative.
* Training on the CPU at a small size: the fused driver with fp32, int8,
  int4 and QAT actors, the actor-learner and async topologies with int8
  actors, and the three bitwise anchors inside the port (actor-learner
  with one actor pushed every iteration is the fused driver; async in
  barrier mode is actor-learner; ``steps_per_call`` 1 and 3 give one
  run).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fake_quant as jfq
from repro.core.qconfig import QuantConfig as JQuantConfig
from repro.rl import buffer as jrb
from repro.rl import dqn as jdqn
from repro.rl.envs import make as jmake
from repro.rl.networks import make_network as jmake_network
from repro_torch.core import ptq
from repro_torch.core.qconfig import QuantConfig
from repro_torch.launch import train as launch_train
from repro_torch.rl import buffer as rb
from repro_torch.rl import common, dqn, loops, networks
from repro_torch.rl.envs import make

NET = dict(conv_filters=(4,), fc_width=16)
SMALL = dict(n_envs=4, rollout_steps=4, updates_per_iter=2,
             buffer_size=512, batch_size=16, warmup=8)


def _pixels(rng, n):
    """Catch-like boards: zeros with a ball (1.0) and a paddle (0.5)."""
    obs = np.zeros((n, 10, 10, 1), np.float32)
    rows = np.arange(n)
    obs[rows, rng.integers(0, 9, n), rng.integers(0, 10, n), 0] = 1.0
    obs[rows, 9, rng.integers(0, 10, n), 0] = 0.5
    return obs


def _jax_state(quant, step, updates, fill, seed):
    """A JAX DQN state on Catch's conv net with a filled replay, non-zero
    Adam moments and target offsets and, for QAT, observers from a
    monitoring forward."""
    rng = np.random.default_rng(seed)
    jenv = jmake("catch")
    jnet = jmake_network((10, 10, 1), 3, **NET)
    jcfg = jdqn.DQNConfig(quant=JQuantConfig.parse(quant), buffer_size=1024)
    st = jax.jit(lambda k: jdqn.init(k, jenv, jnet, jcfg))(
        jax.random.PRNGKey(seed))
    obs, next_obs = _pixels(rng, fill), _pixels(rng, fill)
    replay = jrb.replay_add_batch(st.extras.replay, jrb.Transition(
        jnp.asarray(obs), jnp.asarray(rng.integers(0, 3, fill), jnp.int32),
        jnp.asarray(rng.choice([-1.0, 0.0, 1.0], fill), jnp.float32),
        jnp.asarray((rng.uniform(size=fill) < 0.1).astype(np.float32)),
        jnp.asarray(next_obs)))

    def noise(scale, absolute=False):
        def one(a):
            x = rng.normal(size=a.shape) * scale
            return jnp.asarray(np.abs(x) if absolute else x, jnp.float32)
        return jax.tree_util.tree_map(one, st.params)
    params = jax.tree_util.tree_map(lambda a, b: a + b, st.params,
                                    noise(0.05))
    target = jax.tree_util.tree_map(lambda a, b: a + b, params, noise(0.01))
    opt = st.opt._replace(step=jnp.asarray(10, jnp.int32),
                          m=noise(1e-2), v=noise(1e-3, absolute=True))
    observers = {}
    if jcfg.quant.is_qat:
        ctx = jfq.make_context(jcfg.quant, {}, 0)
        jnet.apply(ctx, params, jnp.asarray(obs[:64]))
        observers = ctx.merged_collection()
    st = st._replace(params=params, opt=opt, observers=observers,
                     step=jnp.asarray(step, jnp.int32),
                     extras=st.extras._replace(
                         target_params=target, replay=replay,
                         updates=jnp.asarray(updates, jnp.int32)))
    return jenv, jnet, jcfg, st, rng


@pytest.mark.parametrize("quant,step,updates", [
    ("none", 300, 99),               # learns; the target syncs at 100
    ("qat8:delay=200", 150, 40),     # QAT, monitoring
    ("qat8:delay=200", 250, 60),     # QAT, quantized
])
def test_conv_td_update_matches_jax(quant, step, updates):
    fill = 600
    jenv, jnet, jcfg, jst, rng = _jax_state(quant, step, updates, fill,
                                            seed=step)
    idx = rng.integers(0, fill, size=64)
    jbatch = jax.tree_util.tree_map(lambda b: b[idx], jst.extras.replay.data)
    jnew, (jloss, jtd) = jax.jit(jdqn.make_td_update(jenv, jnet, jcfg))(
        jst, jbatch, jst.extras.replay.size)

    st = common.state_from_jax(jax.tree_util.tree_map(np.asarray, jst),
                               "cpu")
    env = make("catch")
    net = networks.make_network((10, 10, 1), 3, device="cpu", **NET)
    cfg = dqn.DQNConfig(quant=QuantConfig.parse(quant), buffer_size=1024)
    batch = rb.Transition(*(b[torch.from_numpy(idx)]
                            for b in st.extras.replay.data))
    assert tuple(batch.obs.shape) == (64, 10, 10, 1)
    new, (loss, td) = dqn.make_td_update(env, net, cfg)(
        st, batch, st.extras.replay.size)

    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(td.numpy(), np.asarray(jtd), rtol=1e-5,
                               atol=1e-5)
    for tree, jtree in ((new.params, jnew.params),
                        (new.extras.target_params,
                         jnew.extras.target_params),
                        (new.opt.m, jnew.opt.m), (new.opt.v, jnew.opt.v)):
        for (_, got), want in zip(ptq.tree_tensors(tree),
                                  jax.tree_util.tree_leaves(jtree)):
            assert tuple(got.shape) == tuple(want.shape)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5)
    assert int(new.step) == int(jnew.step) == step + 1
    assert int(new.extras.updates) == int(jnew.extras.updates)
    assert sorted(new.observers) == sorted(jnew.observers)
    if quant != "none":
        assert sorted(new.observers) == ["conv0/out", "fc/out", "out/out"]
    for k, obs in new.observers.items():
        for got, want in zip(obs, jnew.observers[k]):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6)


# ---------------------------------------------------------------------------
# training on the CPU
# ---------------------------------------------------------------------------

def _flat(state):
    return [t for _, t in ptq.tree_tensors(state.params)]


def _same_run(a, b) -> bool:
    return (a.rewards == b.rewards
            and int(a.state.extras.updates) == int(b.state.extras.updates)
            and all(torch.equal(x, y) for x, y in zip(_flat(a.state),
                                                      _flat(b.state))))


@pytest.mark.parametrize("kw", [
    dict(), dict(actor_backend="int8"), dict(actor_backend="int4"),
    dict(actor_backend="int8", calib_batch=8),
    dict(quant=QuantConfig.qat(8, quant_delay=6))],
    ids=["fp32", "int8", "int4", "int8-calib", "qat8"])
def test_fused_catch_trains_with_the_conv_actor(kw):
    res = loops.train("dqn", "catch", iterations=6, record_every=3,
                      eval_episodes=2, seed=1, net_kwargs=NET,
                      algo_overrides=SMALL, device="cpu", **kw)
    assert len(res.rewards) == 2 and all(np.isfinite(res.rewards))
    assert all(-5.0 <= r <= 5.0 for r in res.rewards)
    assert int(res.state.step) == 6 * SMALL["updates_per_iter"]
    assert tuple(res.state.extras.replay.data.obs.shape[1:]) == (10, 10, 1)
    assert tuple(res.state.params["conv0"]["w"].shape) == (3, 3, 1, 4)
    if "quant" in kw:
        assert sorted(res.state.observers) == ["conv0/out", "fc/out",
                                               "out/out"]
        assert all(bool(o.initialized) for o in
                   res.state.observers.values())
    assert res.eval_steps > 0


@pytest.mark.parametrize("topology,extra", [
    ("actor-learner", dict(sync_every=2)),
    ("async", dict(sync_every=4, steps_per_call=2))])
def test_topologies_train_catch_with_int8_conv_actors(topology, extra):
    res = loops.train("dqn", "catch", topology=topology, num_actors=2,
                      actor_backend="int8", iterations=8, record_every=4,
                      eval_episodes=2, seed=2, net_kwargs=NET,
                      algo_overrides=SMALL, device="cpu", **extra)
    assert len(res.rewards) == 2 and all(np.isfinite(res.rewards))
    divs = np.asarray(res.divergences)
    assert divs.ndim == 2 and divs.shape[1] == 2
    assert np.isfinite(divs).all() and bool((divs > 0).any())
    if topology == "async":
        assert res.actor_lags and all(lag >= 4 for lag in res.actor_lags)


@pytest.mark.parametrize("backend", ["fp32", "int8", "int4"])
def test_catch_anchors_are_bitwise_on_cpu(backend):
    kw = dict(iterations=6, record_every=3, eval_episodes=2, seed=7,
              algo_overrides=SMALL, net_kwargs=NET, actor_backend=backend,
              device="cpu")
    fused = loops.train("dqn", "catch", **kw)
    sync = loops.train("dqn", "catch", topology="actor-learner",
                       num_actors=1, sync_every=1, **kw)
    barrier = loops.train("dqn", "catch", topology="async", num_actors=1,
                          sync_every=SMALL["updates_per_iter"],
                          async_barrier=True, steps_per_call=1, **kw)
    chunked = loops.train("dqn", "catch", steps_per_call=3, **kw)
    assert _same_run(fused, sync)
    assert _same_run(sync, barrier)
    assert _same_run(fused, chunked)


def test_launch_train_dqn_catch_on_cpu(capsys):
    argv = ["--algo", "dqn", "--env", "catch", "--iterations", "2",
            "--device", "cpu"]
    assert launch_train.main(argv) == 0
    out = capsys.readouterr().out
    assert "dqn on catch" in out and "device=cpu" in out
