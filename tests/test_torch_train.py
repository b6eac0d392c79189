"""Port parity: the DQN training slice (``rl.envs.cartpole``,
``rl.buffer``, ``optim.adam``, ``rl.common``, ``rl.dqn``'s TD update,
``rl.loops``, ``launch.train``) vs the JAX package, and its contracts
inside the port.

Tolerances, each with its reason:

* CartPole: the reference's dynamics on the same state and action,
  within 1e-6 (``sin``/``cos`` and float32 ops in another library).
* Replay writes: bitwise (index arithmetic and copies).
* Adam: within 1e-6.  ``b ** step`` is a float32 ``pow`` in both
  packages, and the global norm is summed in another order.
* One TD update from the same JAX state, batch, observers and step:
  loss and new params within 1e-5.  The forward and backward matmuls sum
  in another order (an ulp), which Adam's normalised step carries on;
  with QAT on, an activation code may flip (ROADMAP queue C), and the
  flips are logged.
* Inside the port: ``steps_per_call`` 1 and 5 give the same run, bit for
  bit.

JAX's threefry stream is not reproduced by ``torch.Generator``, so whole
runs are compared against bars (``chip_smoke.py``), not trajectories.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fake_quant as jfq
from repro.core.qconfig import QuantConfig as JQuantConfig
from repro.optim import adam as jadam
from repro.rl import buffer as jrb
from repro.rl import dqn as jdqn
from repro.rl.envs import make as jmake
from repro.rl.envs.cartpole import CartPoleState as JCartPoleState
from repro.rl.networks import make_network as jmake_network
from repro_torch.core import fake_quant, ptq
from repro_torch.core.qconfig import QuantConfig
from repro_torch.launch import train as launch_train
from repro_torch.optim import adam
from repro_torch.resilience import ResilienceContext
from repro_torch.rl import buffer as rb
from repro_torch.rl import common, dqn, loops, networks
from repro_torch.rl.envs import make
from repro_torch.rl.envs.cartpole import CartPoleState

SMALL = dict(n_envs=4, rollout_steps=8, buffer_size=512, batch_size=32,
             warmup=64, updates_per_iter=4, target_update_every=8)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# CartPole
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t0", [0, 499])
def test_cartpole_step_matches_jax(t0):
    rng = np.random.default_rng(t0)
    n = 64
    vals = rng.uniform(-0.3, 0.3, size=(4, n)).astype(np.float32)
    vals[2] = rng.uniform(-0.25, 0.25, size=n)        # some past 12 deg
    t = np.full(n, t0, np.int32)
    action = rng.integers(0, 2, size=n).astype(np.int32)
    jenv, env = jmake("cartpole"), make("cartpole")
    jstate = JCartPoleState(*(jnp.asarray(v) for v in vals), jnp.asarray(t))
    jout = jax.vmap(jenv.step, in_axes=(0, 0, None))(
        jstate, jnp.asarray(action), jax.random.PRNGKey(0))
    state = CartPoleState(*(_t(v) for v in vals), _t(t))
    out = env.step(state, _t(action))
    for got, want in zip(out[0][:4], jout[0][:4]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_array_equal(out[0].t.numpy(), np.asarray(jout[0].t))
    np.testing.assert_allclose(out[1].numpy(), np.asarray(jout[1]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(jout[2]))
    np.testing.assert_array_equal(out[3].numpy(), np.asarray(jout[3]))
    if t0 == 499:
        assert bool((out[3] == 1).all())                  # time limit


def test_cartpole_reset_seeded_and_in_range():
    env = make("cartpole")
    s, obs = env.reset(torch.Generator().manual_seed(0), 128, "cpu")
    _, obs2 = env.reset(torch.Generator().manual_seed(0), 128, "cpu")
    assert torch.equal(obs, obs2) and tuple(obs.shape) == (128, 4)
    assert bool((obs.abs() <= 0.05).all()) and bool((s.t == 0).all())
    assert env.spec.n_actions == 2 and env.spec.max_steps == 500


# ---------------------------------------------------------------------------
# replay
# ---------------------------------------------------------------------------

def _transitions(rng, n):
    return (rng.normal(size=(n, 4)).astype(np.float32),
            rng.integers(0, 2, size=n).astype(np.int32),
            rng.normal(size=n).astype(np.float32),
            (rng.uniform(size=n) < 0.1).astype(np.float32),
            rng.normal(size=(n, 4)).astype(np.float32))


def test_replay_add_batch_bitwise_vs_jax():
    rng = np.random.default_rng(0)
    st = rb.replay_init(100, (4,), device="cpu")
    jst = jrb.replay_init(100, (4,))
    for n in (40, 40, 40, 7):                     # wraps around once
        tr = _transitions(rng, n)
        st = rb.replay_add_batch(st, rb.Transition(*(_t(x) for x in tr)))
        jst = jrb.replay_add_batch(jst, jrb.Transition(*(jnp.asarray(x)
                                                         for x in tr)))
        for got, want in zip(st.data, jst.data):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert int(st.index) == int(jst.index)
        assert int(st.size) == int(jst.size)
    assert int(st.size) == 100 and int(st.index) == 27


@pytest.mark.parametrize("size", [0, 1, 37, 100])
def test_replay_sample_draws_from_the_written_prefix(size):
    rng = np.random.default_rng(size)
    st = rb.replay_init(100, (4,), device="cpu")
    if size:
        tr = _transitions(rng, size)
        st = rb.replay_add_batch(st, rb.Transition(*(_t(x) for x in tr)))
    gen = torch.Generator().manual_seed(size)
    idx = rb.sample_indices(st.size, gen, 4096)
    assert int(idx.min()) >= 0 and int(idx.max()) < max(size, 1)
    if size >= 37:
        assert len(set(idx.tolist())) == size      # every slot is reached
    batch = rb.replay_sample(st, gen, 64)
    assert tuple(batch.obs.shape) == (64, 4)
    rows = {tuple(r) for r in st.data.obs[:max(size, 1)].tolist()}
    assert all(tuple(r) in rows for r in batch.obs.tolist())


def test_prioritized_replay_is_not_ported():
    # ported since: alpha > 0 takes the sum-tree, alpha == 0 the uniform
    # path (tests/test_torch_replay.py holds the tree against JAX)
    assert rb.use_prioritized("uniform", 0.6) is False
    assert rb.use_prioritized("prioritized", 0.0) is False
    assert rb.use_prioritized("prioritized", 0.6) is True
    with pytest.raises(ValueError, match="priority_exponent"):
        rb.use_prioritized("prioritized", -0.1)
    with pytest.raises(ValueError, match="replay"):
        rb.validate_replay("lifo")


# ---------------------------------------------------------------------------
# Adam
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grad_scale", [0.01, 10.0])   # clip off / on
def test_adam_update_matches_jax(grad_scale):
    rng = np.random.default_rng(1)
    shapes = {"fc0": {"w": (4, 64), "b": (64,)}, "out": {"w": (64, 2),
                                                         "b": (2,)}}

    def tree(scale):
        return {k: {n: (rng.normal(size=s) * scale).astype(np.float32)
                    for n, s in v.items()} for k, v in shapes.items()}
    params = tree(0.3)
    cfg, jcfg = adam.AdamConfig(lr=1e-3), jadam.AdamConfig(lr=1e-3)
    p = ptq.tree_map(_t, params)
    st = adam.adam_init(p, cfg)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jst = jadam.adam_init(jp, jcfg)
    for _ in range(3):
        grads = tree(grad_scale)
        p, st, stats = adam.adam_update(ptq.tree_map(_t, grads), st, p, cfg)
        jp, jst, jstats = jadam.adam_update(
            jax.tree_util.tree_map(jnp.asarray, grads), jst, jp, jcfg)
        np.testing.assert_allclose(float(stats["grad_norm"]),
                                   float(jstats["grad_norm"]), rtol=1e-6)
        for a, b in ((p, jp), (st.m, jst.m), (st.v, jst.v)):
            for k in shapes:
                for n in shapes[k]:
                    np.testing.assert_allclose(a[k][n].numpy(),
                                               np.asarray(b[k][n]),
                                               rtol=1e-6, atol=1e-6)
    assert int(st.step) == 3
    # 8-bit moments are ported: zero codes and unit scales, as JAX's
    st8 = adam.adam_init(p, adam.AdamConfig(eightbit=True))
    jst8 = jadam.adam_init(jp, jadam.AdamConfig(eightbit=True))
    for k in shapes:
        for n in shapes[k]:
            assert isinstance(st8.m[k][n], adam.BlockQuantized)
            np.testing.assert_array_equal(st8.v[k][n].codes.numpy(),
                                          np.asarray(jst8.v[k][n].codes))
            np.testing.assert_array_equal(st8.m[k][n].scales.numpy(),
                                          np.asarray(jst8.m[k][n].scales))


# ---------------------------------------------------------------------------
# the TD update, from a JAX state carried across
# ---------------------------------------------------------------------------

def _jax_state(quant, step, updates, fill, seed):
    """A JAX DQN state with a filled replay, non-zero Adam moments and,
    for QAT, observers from a monitoring forward."""
    rng = np.random.default_rng(seed)
    jenv = jmake("cartpole")
    jnet = jmake_network((4,), 2)
    jcfg = jdqn.DQNConfig(quant=JQuantConfig.parse(quant))
    st = jdqn.init(jax.random.PRNGKey(seed), jenv, jnet, jcfg)
    tr = _transitions(rng, fill)
    replay = jrb.replay_add_batch(st.extras.replay, jrb.Transition(
        *(jnp.asarray(x) for x in tr)))
    target = jax.tree_util.tree_map(
        lambda a: a + jnp.asarray(rng.normal(size=a.shape) * 0.01,
                                  jnp.float32), st.params)

    def moments(scale):
        return jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.abs(rng.normal(size=a.shape)) * scale,
                                  jnp.float32), st.params)
    opt = st.opt._replace(step=jnp.asarray(10, jnp.int32),
                          m=moments(1e-2), v=moments(1e-3))
    observers = {}
    if jcfg.quant.is_qat:
        ctx = jfq.make_context(jcfg.quant, {}, 0)
        jnet.apply(ctx, st.params, jnp.asarray(tr[0]))
        observers = ctx.merged_collection()
    st = st._replace(opt=opt, observers=observers,
                     step=jnp.asarray(step, jnp.int32),
                     extras=st.extras._replace(
                         target_params=target, replay=replay,
                         updates=jnp.asarray(updates, jnp.int32)))
    return jenv, jnet, jcfg, st, rng


@pytest.mark.parametrize("quant,step,updates,fill", [
    ("none", 0, 0, 100),             # warmup: params held, Adam moves
    ("none", 300, 99, 600),          # learns; the target syncs at 100
    ("qat8:delay=200", 150, 40, 600),    # QAT, monitoring
    ("qat8:delay=200", 250, 60, 600),    # QAT, quantized
    ("qat4:delay=200", 250, 99, 600),    # 4 bits, quantized, target sync
])
def test_td_update_matches_jax(quant, step, updates, fill):
    jenv, jnet, jcfg, jst, rng = _jax_state(quant, step, updates, fill,
                                            seed=step + updates)
    idx = rng.integers(0, fill, size=64)
    jbatch = jax.tree_util.tree_map(lambda b: b[idx], jst.extras.replay.data)
    jnew, (jloss, jtd) = jdqn.make_td_update(jenv, jnet, jcfg)(
        jst, jbatch, jst.extras.replay.size)

    st = common.state_from_jax(jax.tree_util.tree_map(np.asarray, jst),
                               "cpu")
    for got, want in zip(ptq.tree_tensors(st.params),
                         jax.tree_util.tree_leaves(jst.params)):
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want))
    assert int(st.extras.replay.size) == fill
    env, net = make("cartpole"), networks.make_network((4,), 2,
                                                       device="cpu")
    cfg = dqn.DQNConfig(quant=QuantConfig.parse(quant))
    batch = rb.Transition(*(b[torch.from_numpy(idx)]
                            for b in st.extras.replay.data))
    new, (loss, td) = dqn.make_td_update(env, net, cfg)(
        st, batch, st.extras.replay.size)

    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5,
                               atol=1e-5)
    td_diff = np.abs(td.numpy() - np.asarray(jtd))
    print(f"TD {quant} step {step}: {int((td_diff > 1e-6).sum())} of 64 "
          f"|td| off by more than 1e-6 (max {td_diff.max():.3g})")
    for tree, jtree in ((new.params, jnew.params),
                        (new.extras.target_params,
                         jnew.extras.target_params),
                        (new.opt.m, jnew.opt.m), (new.opt.v, jnew.opt.v)):
        for (_, got), want in zip(ptq.tree_tensors(tree),
                                  jax.tree_util.tree_leaves(jtree)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5)
    assert int(new.step) == int(jnew.step) == step + 1
    assert int(new.extras.updates) == int(jnew.extras.updates)
    assert int(new.opt.step) == int(jnew.opt.step) == 11
    assert sorted(new.observers) == sorted(jnew.observers)
    for k, obs in new.observers.items():
        for got, want in zip(obs, jnew.observers[k]):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6)
    if fill < 500:
        for (_, got), (_, old) in zip(ptq.tree_tensors(new.params),
                                      ptq.tree_tensors(st.params)):
            assert torch.equal(got, old)          # warmup holds the params


def test_state_from_jax_carries_every_field():
    _, _, _, jst, _ = _jax_state("qat8:delay=5", 7, 3, 50, seed=0)
    st = common.state_from_jax(jax.tree_util.tree_map(np.asarray, jst),
                               "cpu")
    assert isinstance(st.extras, dqn.DQNExtras)
    pairs = [(st.step, jst.step), (st.opt.step, jst.opt.step),
             (st.extras.updates, jst.extras.updates),
             (st.extras.replay.index, jst.extras.replay.index),
             (st.extras.replay.size, jst.extras.replay.size)]
    pairs += list(zip(st.extras.replay.data, jst.extras.replay.data))
    for k, obs in st.observers.items():
        pairs += list(zip(obs, jst.observers[k]))
    for got, want in pairs:
        assert got.dtype == torch.from_numpy(np.array(want)).dtype
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert sorted(st.observers) == ["fc0/out", "fc1/out", "out/out"]


# ---------------------------------------------------------------------------
# the training loop
# ---------------------------------------------------------------------------

def _flat(tree):
    return [t for _, t in ptq.tree_tensors(tree)]


def test_steps_per_call_is_bitwise_the_per_step_driver():
    runs = [loops.train("dqn", "cartpole", iterations=12, record_every=6,
                        eval_episodes=2, steps_per_call=k,
                        quant=QuantConfig.qat(8, quant_delay=24),
                        algo_overrides=SMALL, seed=3, device="cpu")
            for k in (1, 5)]
    a, b = runs
    assert a.rewards == b.rewards
    assert a.action_variances == b.action_variances
    for x, y in zip(_flat(a.state), _flat(b.state)):
        assert torch.equal(x, y)
    assert int(a.state.step) == 12 * SMALL["updates_per_iter"]


def test_qat_train_20_iterations_on_cpu():
    res = loops.train("dqn", "cartpole", iterations=20, record_every=10,
                      quant=QuantConfig.qat(8, quant_delay=80), seed=0,
                      device="cpu")
    assert len(res.rewards) == 2 and all(np.isfinite(res.rewards))
    assert sorted(res.state.observers) == ["fc0/out", "fc1/out", "out/out"]
    for obs in res.state.observers.values():
        assert bool(obs.initialized) and float(obs.vmax) >= 0.0 >= \
            float(obs.vmin)
    assert float(res.state.observers["fc0/out"].vmax) > 0.0
    assert int(res.state.step) == 160 and int(res.state.extras.updates) > 0
    assert res.device == torch.device("cpu") and res.wall_time_s > 0


def test_b5_call_count_matches_the_config(monkeypatch):
    """Six fake-quant sites a forward, each one call of a site op (one
    launch of B5's site kernel on the card): one forward per behaviour
    step, two (online, target) per TD update, one per eval step -- the
    count ``chip_smoke.py`` holds kernel B5's launches to."""
    from repro_torch.kernels import ops
    calls = [0]

    def counting(real):
        def site(*a, **k):
            calls[0] += 1
            return real(*a, **k)
        return site
    for name in ("qat_activation_site", "qat_weight_site"):
        monkeypatch.setattr(ops, name, counting(getattr(ops, name)))
    it = 3
    res = loops.train("dqn", "cartpole", iterations=it, record_every=3,
                      eval_episodes=2, quant=QuantConfig.qat(8, quant_delay=4),
                      algo_overrides=SMALL, device="cpu")
    steps, upd = SMALL["rollout_steps"], SMALL["updates_per_iter"]
    assert res.eval_steps > 0
    assert calls[0] == 6 * (it * steps + res.eval_steps) + 12 * it * upd


@pytest.mark.parametrize("backend", ["int8", "int4"])
def test_actorq_train_runs_the_fused_actor(monkeypatch, backend):
    from repro_torch.kernels import ops
    calls, real = [0], ops.fused_qmlp

    def counting(*a, **k):
        calls[0] += 1
        return real(*a, **k)
    monkeypatch.setattr(ops, "fused_qmlp", counting)
    res = loops.train("dqn", "cartpole", iterations=4, record_every=4,
                      eval_episodes=2, actor_backend=backend, calib_batch=32,
                      algo_overrides=SMALL, device="cpu")
    assert all(np.isfinite(res.rewards))
    # one fused forward per rollout step and per eval step
    assert calls[0] == 4 * SMALL["rollout_steps"] + res.eval_steps


def test_quarl_pipelines_return_their_rows():
    kw = dict(iterations=3, eval_episodes=2, algo_overrides=SMALL,
              device="cpu")
    row = loops.quarl_qat("dqn", "cartpole", 8, **kw)
    assert row.label == "qat8" and np.isfinite(row.quant_reward)
    assert len(row.extra["rewards_qat"]) == 1
    rows = loops.quarl_ptq("dqn", "cartpole", bits_list=(8, 4, 16), **kw)
    assert [r.label for r in rows] == ["ptq_int8", "ptq_int4", "ptq_fp16"]
    assert len({r.fp32_reward for r in rows}) == 1
    assert all(np.isfinite(r.quant_reward) for r in rows)
    assert rows[0].extra["weight_stats"]["range"] > 0
    fp = loops.train("dqn", "cartpole", iterations=2, eval_episodes=2,
                     algo_overrides=SMALL, device="cpu")
    again = loops.quarl_ptq("dqn", "cartpole", bits_list=(8,), result=fp,
                            eval_episodes=2, actor_backend="int8")
    assert again[0].label == "ptq_int8" and np.isfinite(
        again[0].quant_reward)


def test_unported_options_raise(tmp_path):
    kw = dict(iterations=1, device="cpu")
    # the topologies and prioritized replay are ported (item 7), and the
    # actor mesh (item 14a); a mesh with checkpoints or the resilience
    # hooks is not (item 14c), and fused-only knobs given to the fused
    # driver are refused as in the reference
    with pytest.raises(NotImplementedError, match="item 14c"):
        loops.train("dqn", "cartpole", topology="async", mesh=object(),
                    checkpoint_dir=str(tmp_path), **kw)
    # the resilience hooks are ported (item 11): a real context runs, as
    # the reference's, and its guards see nothing to report
    ctx = ResilienceContext()
    assert loops.train("dqn", "cartpole", resilience=ctx, **kw).rewards
    assert ctx.events == [] and ctx.quarantined == []
    # checkpointing is ported: its knobs are validated as the reference's
    for extra in (dict(resume=True), dict(checkpoint_every=5)):
        with pytest.raises(ValueError, match="needs checkpoint_dir"):
            loops.train("dqn", "cartpole", **kw, **extra)
    with pytest.raises(ValueError, match="actor-learner knobs"):
        loops.train("dqn", "cartpole", num_actors=2, **kw)
    with pytest.raises(NotImplementedError, match="item 14c"):
        loops.train("ddpg", "pendulum", topology="actor-learner",
                    mesh=object(), resilience=ResilienceContext(), **kw)
    with pytest.raises(ValueError, match="algo"):
        loops.train("sac", "cartpole", **kw)
    net = networks.make_network((6, 27), 3, transformer={"d_model": 8,
                                                         "n_layers": 1},
                                device="cpu")
    # the sequence policy's QAT sites are ported: the forward runs them
    ctx = fake_quant.make_context(QuantConfig.qat(8), {}, torch.tensor(0))
    out = net.apply(net.init(torch.Generator().manual_seed(0)),
                    torch.zeros(2, 6, 27), ctx=ctx)
    assert out.shape == (2, 3)
    assert sorted(ctx.merged_collection()) == [
        "blk0/fc/out", "blk0/k/out", "blk0/o/out", "blk0/proj/out",
        "blk0/q/out", "blk0/v/out", "embed/out", "head/out"]
    with pytest.raises(ValueError, match="kernel_backend"):
        dqn.make_iteration(make("cartpole"), networks.make_network(
            (4,), 2, device="cpu"), dataclasses.replace(
                dqn.DQNConfig(), kernel_backend="ref"), device="cpu")


def test_launch_train_rl_on_cpu(capsys):
    argv = ["--mode", "rl", "--algo", "dqn", "--env", "cartpole",
            "--quant", "qat8:delay=16", "--iterations", "4",
            "--device", "cpu"]
    assert launch_train.main(argv) == 0
    out = capsys.readouterr().out
    assert "quant=qat8" in out and "device=cpu" in out
    # --mode lm is ported, the encoder configs too
    assert launch_train.main(argv + ["--mode", "lm", "--arch",
                                     "whisper-tiny", "--reduced", "--steps",
                                     "2", "--batch", "2", "--seq", "16"]) == 0
    assert "[train/lm] whisper-tiny-reduced" in capsys.readouterr().out
    # the supervisor is ported (item 11): both flags run and report
    for extra, fired in ((["--fault-plan", "1:straggler@1:delay_s=0.001"],
                          True), (["--supervised"], False)):
        assert launch_train.main(argv + extra) == 0
        out = capsys.readouterr().out
        assert "supervisor: ok after 1 attempt(s)" in out
        assert ("faults fired: straggler@1" in out) == fired
    # the checkpoint flags are ported: a resume needs a directory
    with pytest.raises(ValueError, match="needs checkpoint_dir"):
        launch_train.main(argv + ["--resume"])
