"""Port parity: the sequence actor in training (``models.seq_policy``'s
QAT sites, ``rl.dqn``'s TD update on a sequence policy, the topologies)
vs the JAX package, and its contracts inside the port.

Tolerances, each with its reason:

* The QAT forward: observer ranges from a monitoring forward within rtol
  1e-6 (``x @ w`` sums in another order on XLA:CPU and in torch), then,
  from the same ranges, a forward whose values may differ where an
  activation code flips on a rounding boundary (at most 5e-3, in at most
  an eighth of the values), as ``test_torch_qat.py`` allows the MLP.
* One TD update from the same JAX state (``common.state_from_jax``),
  batch, observers and step: loss and new params within 1e-5, the
  observers within rtol 1e-6.
* Inside the port: actor-learner with one actor pushed every iteration
  is the fused driver, and async in barrier mode is actor-learner, bit
  for bit; the kernel calls of a run are exact.
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
from repro_torch.core import fake_quant, ptq
from repro_torch.core.qconfig import QuantConfig
from repro_torch.kernels import ops
from repro_torch.rl import buffer as rb
from repro_torch.rl import common, dqn, loops, networks
from repro_torch.rl.envs import make

NET = dict(d_model=16, n_layers=2, d_ff=32)
OBS = (6, 27)                          # catch_seq: 6 frames of 27 features
FLIP_ATOL = 5e-3
SMALL = dict(n_envs=2, rollout_steps=3, updates_per_iter=2, buffer_size=64,
             batch_size=8, warmup=8)


def _t(a):
    return torch.from_numpy(np.array(a))


def _obs(rng, n):
    """Frame stacks as the env makes them: features, then the time and
    valid columns, the first ``k`` rows of each stack before the episode
    (all zero, valid 0)."""
    x = rng.normal(size=(n,) + OBS).astype(np.float32)
    x[..., -2] = rng.uniform(size=(n, OBS[0]))
    x[..., -1] = 1.0
    for i, k in enumerate(rng.integers(0, OBS[0], size=n)):
        x[i, :k] = 0.0
    return x


def _nets(seed):
    jnet = jmake_network(OBS, 3, transformer=dict(NET))
    jparams = jnet.init(jax.random.PRNGKey(seed))
    net = networks.make_network(OBS, 3, transformer=dict(NET), device="cpu")
    return jnet, jparams, net, networks.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu")


def _sites(n_layers):
    return ["embed/out", "head/out"] + [
        f"blk{i}/{s}/out" for i in range(n_layers)
        for s in ("q", "k", "v", "o", "fc", "proj")]


# ---------------------------------------------------------------------------
# the QAT sites of the sequence policy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step", [10, 40])
def test_qat_seq_forward_matches_jax_up_to_flips(step):
    """Observers from a monitoring forward in each package (within an
    ulp), then, from the same ranges, a forward on new stacks before
    (step 10) and after (step 40) the delay of 20."""
    jnet, jparams, net, params = _nets(step)
    rng = np.random.default_rng(step)
    cfg, jcfg = (QuantConfig.qat(8, quant_delay=20),
                 JQuantConfig.qat(8, quant_delay=20))
    warm = _obs(rng, 16)
    ctx = fake_quant.make_context(cfg, {}, torch.tensor(0))
    net.apply(params, _t(warm), ctx=ctx)
    jctx = jfq.make_context(jcfg, {}, jnp.asarray(0))
    jnet.apply(jctx, jparams, jnp.asarray(warm))
    coll, jcoll = ctx.merged_collection(), jctx.merged_collection()
    assert sorted(coll) == sorted(jcoll) == sorted(_sites(NET["n_layers"]))
    for k in coll:
        for g, w in zip(coll[k], jcoll[k]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    jcoll = {k: jfq.ObserverState(*(jnp.asarray(x.numpy()) for x in v))
             for k, v in coll.items()}
    x = _obs(rng, 16)
    got = net.apply(params, _t(x), ctx=fake_quant.make_context(
        cfg, coll, torch.tensor(step))).numpy()
    want = np.asarray(jnet.apply(jfq.make_context(jcfg, jcoll,
                                                  jnp.asarray(step)),
                                 jparams, jnp.asarray(x)))
    diff = np.abs(got - want)
    flips = int((diff > 1e-6).sum())
    print(f"QAT seq step={step}: {flips} of {diff.size} values off by more "
          f"than 1e-6 (max {diff.max():.3g})")
    assert got.shape == (16, 3)
    assert diff.max() <= FLIP_ATOL and flips <= diff.size // 8


def test_null_context_forward_is_the_fp32_forward():
    _, _, net, params = _nets(1)
    x = _t(_obs(np.random.default_rng(1), 4))
    base = net.apply(params, x)
    for ctx in (fake_quant.NullQATContext(),
                fake_quant.make_context(QuantConfig.none(), {}, 0)):
        assert torch.equal(net.apply(params, x, ctx=ctx), base)


# ---------------------------------------------------------------------------
# the TD update of a sequence actor, from a JAX state carried across
# ---------------------------------------------------------------------------

def _jax_state(quant, step, updates, fill, seed):
    rng = np.random.default_rng(seed)
    jenv = jmake("catch_seq")
    jnet = jmake_network(OBS, 3, transformer=dict(NET))
    jcfg = jdqn.DQNConfig(quant=JQuantConfig.parse(quant), buffer_size=256,
                          batch_size=16)
    st = jdqn.init(jax.random.PRNGKey(seed), jenv, jnet, jcfg)
    tr = jrb.Transition(
        jnp.asarray(_obs(rng, fill)),
        jnp.asarray(rng.integers(0, 3, size=fill).astype(np.int32)),
        jnp.asarray(rng.normal(size=fill).astype(np.float32)),
        jnp.asarray((rng.uniform(size=fill) < 0.2).astype(np.float32)),
        jnp.asarray(_obs(rng, fill)))
    replay = jrb.replay_add_batch(st.extras.replay, tr)
    target = jax.tree_util.tree_map(
        lambda a: a + jnp.asarray(rng.normal(size=a.shape) * 0.01,
                                  jnp.float32), st.params)

    def moments(scale):
        return jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.abs(rng.normal(size=a.shape)) * scale,
                                  jnp.float32), st.params)
    observers = {}
    if jcfg.quant.is_qat:
        ctx = jfq.make_context(jcfg.quant, {}, 0)
        jnet.apply(ctx, st.params, tr.obs[:32])
        observers = ctx.merged_collection()
    st = st._replace(opt=st.opt._replace(step=jnp.asarray(10, jnp.int32),
                                         m=moments(1e-2), v=moments(1e-3)),
                     observers=observers, step=jnp.asarray(step, jnp.int32),
                     extras=st.extras._replace(
                         target_params=target, replay=replay,
                         updates=jnp.asarray(updates, jnp.int32)))
    return jenv, jnet, jcfg, st, rng


@pytest.mark.parametrize("quant,backend,step", [
    ("none", "fp32", 40),
    ("none", "int8", 40),                 # the ActorQ actor: same learner
    ("qat8:delay=50", "fp32", 40),        # QAT, monitoring
    ("qat8:delay=50", "int8", 60),        # QAT, quantized
])
def test_seq_td_update_matches_jax(quant, backend, step):
    jenv, jnet, jcfg, jst, rng = _jax_state(quant, step, 20, 100,
                                            seed=step)
    idx = rng.integers(0, 100, size=16)
    jbatch = jax.tree_util.tree_map(lambda b: b[idx], jst.extras.replay.data)
    jnew, (jloss, jtd) = jdqn.make_td_update(jenv, jnet, jcfg)(
        jst, jbatch, jst.extras.replay.size)

    st = common.state_from_jax(jax.tree_util.tree_map(np.asarray, jst),
                               "cpu")
    net = networks.make_network(OBS, 3, transformer=dict(NET), device="cpu")
    cfg = dqn.DQNConfig(quant=QuantConfig.parse(quant), actor_backend=backend,
                        buffer_size=256, batch_size=16)
    batch = rb.Transition(*(b[torch.from_numpy(idx)]
                            for b in st.extras.replay.data))
    new, (loss, td) = dqn.make_td_update(make("catch_seq"), net, cfg)(
        st, batch, st.extras.replay.size)

    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5,
                               atol=1e-5)
    td_diff = np.abs(td.numpy() - np.asarray(jtd))
    print(f"seq TD {quant} {backend}: {int((td_diff > 1e-6).sum())} of 16 "
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
    assert sorted(new.observers) == sorted(jnew.observers)
    for k, obs in new.observers.items():
        for got, want in zip(obs, jnew.observers[k]):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6)


def test_state_from_jax_carries_a_sequence_policy():
    _, _, _, jst, _ = _jax_state("qat8:delay=50", 7, 3, 40, seed=0)
    st = common.state_from_jax(jax.tree_util.tree_map(np.asarray, jst),
                               "cpu")
    got = dict(ptq.tree_tensors(st.params))
    assert sorted(got) == sorted(
        "/" + "/".join(k.key for k in path) for path, _ in
        jax.tree_util.tree_flatten_with_path(jst.params)[0])
    for (_, g), w in zip(ptq.tree_tensors(st.params),
                         jax.tree_util.tree_leaves(jst.params)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert sorted(st.observers) == sorted(_sites(NET["n_layers"]))
    for k, obs in st.observers.items():
        for g, w in zip(obs, jst.observers[k]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# training runs inside the port
# ---------------------------------------------------------------------------

def _train(backend="int8", **kw):
    kw.setdefault("algo_overrides", dict(SMALL))
    return loops.train("dqn", "catch_seq", iterations=4, record_every=2,
                       eval_episodes=2, seed=5, actor_backend=backend,
                       net_kwargs={"transformer": dict(NET)}, device="cpu",
                       **kw)


def _bitwise(a, b):
    pa, pb = ptq.tree_tensors(a.state.params), ptq.tree_tensors(
        b.state.params)
    return a.rewards == b.rewards and all(
        torch.equal(x, y) for (_, x), (_, y) in zip(pa, pb))


@pytest.mark.parametrize("backend", ["fp32", "int8"])
def test_seq_anchors_bitwise(backend):
    fused = _train(backend)
    sync = _train(backend, topology="actor-learner", num_actors=1,
                  sync_every=1)
    barrier = _train(backend, topology="async", num_actors=1,
                     sync_every=SMALL["updates_per_iter"],
                     async_barrier=True, steps_per_call=1)
    assert _bitwise(fused, sync)
    assert _bitwise(sync, barrier)
    assert int(fused.state.extras.updates) > 0


class _Counts:
    """Calls of the B1, B3 and B5 entry points (one launch each on the
    card, a B5 site above 4,096 elements aside)."""

    def __init__(self, monkeypatch):
        self.n = dict(int8_matmul=0, int8_cache_attention=0, fake_quant=0)
        for name, key in (("int8_matmul", "int8_matmul"),
                          ("int8_cache_attention", "int8_cache_attention"),
                          ("qat_activation_site", "fake_quant"),
                          ("qat_weight_site", "fake_quant")):
            monkeypatch.setattr(ops, name, self._counting(
                getattr(ops, name), key))

    def _counting(self, real, key):
        def call(*a, **k):
            self.n[key] += 1
            return real(*a, **k)
        return call


@pytest.mark.parametrize("run", ["int8", "qat8_int8", "al_int8"])
def test_seq_kernel_calls_match_the_config(monkeypatch, run):
    """B1 at every dense layer (2 + 6 * n_layers) of each behaviour step
    (the cached stepper), eval step (the windowed int8 forward) and
    divergence head (one an actor at each push); B3 once a layer a
    behaviour step; B5 at the 4 + 12 * n_layers sites of both forwards of
    each TD update of a QAT run."""
    counts = _Counts(monkeypatch)
    it, n_l = 3, NET["n_layers"]
    kw = dict(record_every=3, iterations=it)
    actors, pushes = 1, 0
    if run == "qat8_int8":
        kw["quant"] = QuantConfig.qat(8, quant_delay=2)
    if run == "al_int8":
        actors = 2
        kw.update(topology="actor-learner", num_actors=2, sync_every=2)
        pushes = it // 2
    res = loops.train("dqn", "catch_seq", eval_episodes=2, seed=1,
                      actor_backend="int8", algo_overrides=dict(SMALL),
                      net_kwargs={"transformer": dict(NET)}, device="cpu",
                      **kw)
    steps = it * SMALL["rollout_steps"]
    dense = 2 + 6 * n_l
    assert res.eval_steps > 0
    assert counts.n == dict(
        int8_matmul=dense * (steps + res.eval_steps + pushes * actors),
        int8_cache_attention=n_l * steps,
        fake_quant=(2 * (4 + 12 * n_l) * it * SMALL["updates_per_iter"]
                    if run == "qat8_int8" else 0))
    if run == "qat8_int8":
        assert sorted(res.state.observers) == sorted(_sites(n_l))


def test_qat_seq_train_with_the_fp32_actor(monkeypatch):
    """The QAT behaviour policy of an fp32 actor is the windowed forward
    under the context: B5 at every site of each behaviour step, eval step
    and both TD forwards; no B1 or B3."""
    counts = _Counts(monkeypatch)
    it, n_l = 2, NET["n_layers"]
    res = loops.train("dqn", "catch_seq", iterations=it, record_every=2,
                      eval_episodes=2, seed=2,
                      quant=QuantConfig.qat(8, quant_delay=3),
                      algo_overrides=dict(SMALL),
                      net_kwargs={"transformer": dict(NET)}, device="cpu")
    sites = 4 + 12 * n_l
    assert all(np.isfinite(res.rewards))
    assert counts.n == dict(
        int8_matmul=0, int8_cache_attention=0,
        fake_quant=sites * (it * SMALL["rollout_steps"] + res.eval_steps
                            + 2 * it * SMALL["updates_per_iter"]))
