"""Port parity: the sequence-policy actor slice (``repro_torch.models``,
``rl.actorq`` sequence path, ``rl.env`` rollout, ``rl.envs`` Catch and
wrappers, ``rl.dqn`` behaviour policy) vs the JAX package.

Tolerances, each with its reason:

* fp32 ``seq_apply``: rtol = atol = 1e-5.  The two packages take the
  rms-norm mean, ``rsqrt`` and the attention sums in another order, an
  ulp or so apart.
* The quantized actor (``quantized_seq_apply``, ``quantized_seq_step``):
  most values within 1e-5, the rest within ``FLIP_ATOL``, with equal
  greedy actions.  The per-tensor activation quantizer rounds ``x /
  delta``, so a one-ulp difference of ``x`` (from ``rms_norm`` or the
  attention, above) moves a code by one wherever the quotient sits on a
  rounding boundary, and a moved code can move the range of the next
  per-tensor quantizer, and with it every row of the batch.  Such a flip
  moves the head by about one activation step times a weight: the largest
  measured is 1.93e-3 (int8, 2 blocks, ``PRNGKey(4)`` params, one of the
  cases below; logged in ROADMAP queue C).  So every value is held within
  ``FLIP_ATOL`` = 5e-3 and at least ``TIGHT_SHARE`` of them within 1e-5;
  with the layer inputs equal, each dense layer is bitwise equal
  (``tests/test_torch_actorq.py``) and the attention within 1e-5
  (``tests/test_torch_attention.py``).  The cache's scales follow the same
  rule relative to their size, and its codes may differ by one where a
  flip reached the token.
* Env steps: the reference's own dynamics on the same state and action,
  within 1e-6 (float32 ops in another library).

Inputs are numpy arrays from a seed (or JAX's own reset states, converted)
handed to both packages.  The JAX side runs its ``ref`` oracle, as the
JAX package's own tests do on the CPU.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.fake_quant import NullQATContext
from repro.rl import actorq as jactorq
from repro.rl import dqn as jdqn
from repro.rl.env import batched_env as jbatched_env
from repro.rl.envs import make as jmake
from repro.rl.networks import make_network as jmake_network
from repro_torch.core import ptq
from repro_torch.models.seq_policy import SeqPolicyConfig
from repro_torch.rl import actorq, dqn, networks
from repro_torch.rl import env as env_mod
from repro_torch.rl.env import batched_env
from repro_torch.rl.envs import ENVS, make

SEQ_NET = {"d_model": 16, "n_layers": 2, "d_ff": 32}
FLIP_ATOL = 5e-3
TIGHT_SHARE = 0.75


def _nets(obs_shape, out_dim, seed, **net):
    jnet = jmake_network(obs_shape, out_dim, transformer={**SEQ_NET, **net})
    jparams = jnet.init(jax.random.PRNGKey(seed))
    tparams = networks.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    tnet = networks.make_network(obs_shape, out_dim,
                                 transformer={**SEQ_NET, **net},
                                 device="cpu")
    return jnet, jparams, tnet, tparams


def _frame_obs(b, s, f, seed):
    """Frame stacks with a random number of valid (newest) rows."""
    rng = np.random.default_rng(seed)
    obs = rng.normal(size=(b, s, f)).astype(np.float32)
    n_valid = rng.integers(1, s + 1, size=b)
    for i in range(b):
        obs[i, :s - n_valid[i]] = 0.0
        obs[i, s - n_valid[i]:, -1] = 1.0
    return obs


def _close_up_to_flips(got, want, atol=FLIP_ATOL):
    """Every value within ``atol`` of the reference (see the module
    docstring); returns the mask of values within 1e-5 of it."""
    d = np.abs(np.asarray(got, np.float64) - want)
    assert d.max() <= atol, d.max()
    return d <= 1e-5 + 1e-5 * np.abs(want)


# ---------------------------------------------------------------------------
# the network
# ---------------------------------------------------------------------------

def test_network_spec_init_and_params_from_jax():
    jnet, jparams, tnet, tparams = _nets((6, 27), 3, seed=0)
    assert tnet.seq_cfg == SeqPolicyConfig(6, 27, 16, 2, 32, 3)
    mine = tnet.init(torch.Generator().manual_seed(0))
    shapes_j = sorted(("/" + "/".join(k.key for k in path), v.shape)
                      for path, v in jax.tree_util.tree_flatten_with_path(
                          jparams)[0])
    shapes_t = sorted((path, tuple(t.shape))
                      for path, t in ptq.tree_tensors(mine))
    assert shapes_t == shapes_j
    for path, t in ptq.tree_tensors(tparams):          # carried unchanged
        keys = path[1:].split("/")
        want = functools.reduce(lambda node, k: node[k], keys, jparams)
        np.testing.assert_array_equal(t.numpy(), np.asarray(want))
    assert not bool(mine["blk0"]["ln1"]["scale"].any())
    assert float(mine["head"]["w"].std()) < 0.03       # head scale 0.01
    mlp = networks.make_network((9,), 25, hidden=(8,), device="cpu")
    assert mlp.seq_cfg is None
    assert tuple(mlp.init(torch.Generator())["fc0"]["w"].shape) == (9, 8)
    conv = networks.make_network((5, 5, 1), 3, device="cpu")   # pixels
    assert conv.seq_cfg is None
    assert tuple(conv.init(torch.Generator())["conv0"]["w"].shape) == (
        3, 3, 1, 16)
    with pytest.raises(ValueError, match="obs_shape"):
        networks.make_network((8,), 3, transformer={}, device="cpu")


def test_seq_apply_fp32_matches_jax():
    jnet, jparams, tnet, tparams = _nets((6, 27), 3, seed=1)
    obs = _frame_obs(40, 6, 27, seed=1)
    want = np.asarray(jnet.apply(NullQATContext(), jparams,
                                 jnp.asarray(obs)))
    got = tnet.apply(tparams, torch.from_numpy(obs)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    module = networks.SeqPolicy(tparams, tnet.seq_cfg)
    lead = module(torch.from_numpy(obs).reshape(4, 10, 6, 27))
    assert torch.equal(lead.reshape(40, 3).detach(), torch.from_numpy(got))
    assert set(module.params()) == {"embed", "blk0", "blk1", "head"}


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("n_layers", [1, 2])
def test_quantized_seq_apply_matches_jax(bits, n_layers):
    # PRNGKey(4) with 2 blocks shows one int8 code flip (module docstring)
    jnet, jparams, _, tparams = _nets((6, 27), 3, seed=4,
                                      n_layers=n_layers)
    obs = _frame_obs(64, 6, 27, seed=4)
    jq = jactorq.pack_actor_params(jparams, bits)
    tq = actorq.pack_actor_params(tparams, bits)
    assert actorq.packed_nbytes(tq) == jactorq.packed_nbytes(jq)
    want = np.asarray(jactorq.quantized_seq_apply(jq, jnp.asarray(obs),
                                                  backend="ref"))
    got = actorq.quantized_seq_apply(tq, torch.from_numpy(obs)).numpy()
    assert _close_up_to_flips(got, want).mean() >= TIGHT_SHARE
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    # quantized_apply dispatches on the "embed" key
    assert np.array_equal(
        actorq.quantized_apply(tq, torch.from_numpy(obs)).numpy(), got)


@pytest.mark.parametrize("bits", [4, 8])
def test_quantized_seq_step_episode_matches_jax(bits):
    """A whole episode of frame rows, one decode step at a time: per-step
    Q-values, then the cache codes and scales of every env."""
    b, steps, context = 16, 20, 6
    jnet, jparams, tnet, tparams = _nets((context, 11), 5, seed=2)
    jq = jactorq.pack_actor_params(jparams, bits)
    tq = actorq.pack_actor_params(tparams, bits)
    feats = _frame_obs(b, steps, 11, seed=3)
    feats[..., -1] = 1.0
    jps = jactorq.seq_cache_zeros(jnet.seq_cfg, b, steps + 1)
    tps = actorq.seq_cache_zeros(tnet.seq_cfg, b, steps + 1, device="cpu")
    jstep = functools.partial(jactorq.quantized_seq_step, context=context,
                              backend="ref")
    tight = []
    for t in range(steps):
        jqv, jps = jstep(jq, jnp.asarray(feats[:, t]), jps)
        tqv, tps = actorq.quantized_seq_step(
            tq, torch.from_numpy(feats[:, t]), tps, context=context)
        tight.append(_close_up_to_flips(tqv.numpy(), np.asarray(jqv)))
        np.testing.assert_array_equal(tqv.numpy().argmax(-1),
                                      np.asarray(jqv).argmax(-1))
    assert np.mean(tight) >= TIGHT_SHARE
    np.testing.assert_array_equal(tps["count"].numpy(), np.asarray(
        jps["count"]))
    for jl, tl in zip(jps["layers"], tps["layers"]):
        for name in ("k_codes", "v_codes"):
            d = np.abs(tl[name].numpy().astype(np.int32)
                       - np.asarray(jl[name]).astype(np.int32))
            assert d.max() <= 1 and d.mean() <= 1e-2, name
        for name in ("k_scale", "v_scale"):
            want = np.asarray(jl[name])
            rel = np.abs(tl[name].numpy() - want) / np.maximum(want, 1e-30)
            assert rel.max() <= 1e-2 and np.mean(rel <= 1e-5) >= TIGHT_SHARE
    assert actorq.seq_cache_nbytes(tps) == jactorq.seq_cache_nbytes(jps)


# ---------------------------------------------------------------------------
# envs: one step from the same state and action
# ---------------------------------------------------------------------------

def _to_port(jtree, ttree):
    """A JAX env state in the structure (and dtypes) of a port state."""
    if isinstance(ttree, torch.Tensor):
        return torch.from_numpy(np.array(jtree)).to(ttree.dtype)
    if isinstance(ttree, dict):
        return {k: _to_port(jtree[k], v) for k, v in ttree.items()}
    if isinstance(ttree, tuple) and not hasattr(ttree, "_fields"):
        return tuple(_to_port(j, t) for j, t in zip(jtree, ttree))
    return type(ttree)(**{f: _to_port(getattr(jtree, f), getattr(ttree, f))
                          for f in ttree._fields})


def _jax_states(name, b, n_steps, seed):
    """Batched JAX states after ``n_steps`` random steps (no reset)."""
    jenv = jbatched_env(jmake(name), b)
    key = jax.random.PRNGKey(seed)
    state, _ = jenv.reset(key)
    rng = np.random.default_rng(seed)
    step = jax.jit(jenv.step)
    for i in range(n_steps):
        act = jnp.asarray(rng.integers(0, jenv.spec.n_actions, size=b),
                          jnp.int32)
        state, _, _, _ = step(state, act, jax.random.fold_in(key, i))
    return jenv, state


@pytest.mark.parametrize("name,n_steps", [
    ("catch", 0), ("catch", 8), ("catch_masked", 3), ("airnav_flicker", 2),
    ("catch_seq", 3), ("airnav_seq", 4), ("airnav_seq", 119)])
def test_env_step_matches_jax(name, n_steps):
    b = 32
    jenv, jstate = _jax_states(name, b, n_steps, seed=n_steps + 1)
    tenv = make(name)
    assert tenv.spec == type(tenv.spec)(**vars(jenv.spec))
    template, _ = tenv.reset(torch.Generator().manual_seed(0), b, "cpu")
    tstate = _to_port(jstate, template)
    actions = np.random.default_rng(n_steps).integers(
        0, jenv.spec.n_actions, size=b).astype(np.int32)
    key = jax.random.PRNGKey(99)
    jout = jenv.step(jstate, jnp.asarray(actions), key)
    tout = tenv.step(tstate, torch.from_numpy(actions),
                     torch.Generator().manual_seed(1))
    respawn = None
    if name.startswith("catch"):
        # the ball respawns at a column each package draws on its own
        inner = jout[0]
        while not hasattr(inner, "ball_x"):
            inner = inner.inner
        respawn = np.asarray(inner.ball_y) == 0
    for what, j, t in (("obs", jout[1], tout[1]),
                       ("reward", jout[2], tout[2]),
                       ("done", jout[3], tout[3])):
        j, t = np.asarray(j), t.numpy()
        if respawn is not None and what == "obs":
            j, t = j[~respawn], t[~respawn]
        np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6, err_msg=what)
    if n_steps == 119:
        assert bool((tout[3] == 1).all())                  # timeout


def test_framestack_rows_and_reset():
    env = batched_env(make("airnav_seq"), 4)
    state, obs = env.reset(torch.Generator().manual_seed(0), "cpu")
    assert tuple(obs.shape) == (4, 8, 11) and env.spec.max_steps == 120
    assert not bool(obs[:, :-1].any())                     # pre-episode
    assert bool((obs[:, -1, -1] == 1).all()) and not bool(obs[:, -1, -2]
                                                          .any())
    state, obs, _, _ = env.step(state, torch.zeros(4, dtype=torch.int32))
    assert torch.equal(obs[:, -1, -2], torch.full((4,), 1.0 / 120))
    assert bool((obs[:, -1, :9] == 0).all())               # flicker off
    assert obs.data_ptr() != state.frames.data_ptr()
    assert sorted(ENVS) == ["airnav", "airnav_flicker", "airnav_seq",
                            "cartpole", "catch", "catch_masked", "catch_seq",
                            "mountaincar", "mountaincar_continuous",
                            "pendulum"]


# ---------------------------------------------------------------------------
# greedy episodes through the behaviour policies of both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["catch_seq", "airnav_seq"])
def test_greedy_episode_matches_jax(name):
    """epsilon = 0, int8 cached actors, the same converted reset state:
    per-step Q within the flip tolerance, equal actions and rewards over
    the first episode of every env."""
    b = 8
    jenv = jbatched_env(jmake(name), b)
    tenv = batched_env(make(name), b)
    spec = tenv.spec
    jnet, jparams, tnet, tparams = _nets(spec.obs_shape, spec.n_actions,
                                         seed=5)
    jcfg = jdqn.DQNConfig(actor_backend="int8", eps_start=0.0,
                          eps_end=0.0, kernel_backend="ref")
    tcfg = dqn.DQNConfig(actor_backend="int8", eps_start=0.0, eps_end=0.0)
    jpol = jdqn.make_behaviour_policy(jenv, jnet, jcfg)(
        jparams, {}, jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32))
    tpol = dqn.make_behaviour_policy(tenv, tnet, tcfg)(
        tparams, {}, torch.zeros((), dtype=torch.int32),
        torch.zeros((), dtype=torch.int32))
    jstate, jobs = jenv.reset(jax.random.PRNGKey(7))
    template, _ = tenv.reset(torch.Generator().manual_seed(0), "cpu")
    tstate, tobs = _to_port(jstate, template), torch.from_numpy(
        np.array(jobs))
    size = spec.max_steps + 1
    jps = jactorq.seq_cache_zeros(jnet.seq_cfg, b, size)
    tps = actorq.seq_cache_zeros(tnet.seq_cfg, b, size, device="cpu")
    japply = jax.jit(jpol.apply)
    jenv_step = jax.jit(jenv.step)
    gen = torch.Generator().manual_seed(0)
    live = np.ones(b, bool)
    tight = []
    for t in range(spec.max_steps):
        key = jax.random.PRNGKey(t)
        ja, jps, jq = japply(jparams, jobs, jps, key)
        ta, tps, tq = tpol.apply(tparams, tobs, tps, gen)
        tight.append(_close_up_to_flips(tq.numpy()[live],
                                        np.asarray(jq)[live]).mean())
        np.testing.assert_array_equal(ta.numpy()[live], np.asarray(ja)[live])
        jstate, jobs, jr, jd = jenv_step(jstate, ja, key)
        tstate, tobs, tr, td = tenv.step(tstate, ta, gen)
        np.testing.assert_allclose(tr.numpy()[live], np.asarray(jr)[live],
                                   rtol=1e-5, atol=1e-4)
        np.testing.assert_array_equal(td.numpy()[live], np.asarray(jd)[live])
        live &= np.asarray(jd) == 0
        if not live.any():
            break
    assert not live.any() or t == spec.max_steps - 1
    assert np.mean(tight) >= TIGHT_SHARE


# ---------------------------------------------------------------------------
# inside the port
# ---------------------------------------------------------------------------

def _seq_actor(name, b, backend="int8", seed=0):
    env = make(name)
    net = networks.make_network(env.spec.obs_shape, env.spec.n_actions,
                                transformer=dict(SEQ_NET), device="cpu")
    params = net.init(torch.Generator().manual_seed(seed))
    benv = actorq.maybe_attach_seq_state(batched_env(env, b), net, backend,
                                         b, device="cpu")
    return env, net, params, benv


def test_auto_reset_restores_policy_state():
    """A finished env's KV cache and ``count`` return to ``pstate0`` in
    the same step; the others keep counting."""
    env, net, params, benv = _seq_actor("catch_seq", 6)
    pol = dqn.make_behaviour_policy(benv, net, dqn.DQNConfig(
        actor_backend="int8"))(params, {}, torch.tensor(0),
                               torch.tensor(0))
    gen = torch.Generator().manual_seed(1)
    state, obs = benv.reset(gen, "cpu")
    pstate0 = state[1]
    n_done = 0
    for _ in range(2 * env.spec.max_steps):
        count_before = state[1]["count"].clone()
        state, obs, traj = env_mod.rollout(benv, pol, params, state, obs,
                                           gen, 1)
        done = traj.done[0] > 0
        ps = state[1]
        n_done += int(done.sum())
        assert torch.equal(ps["count"][done], torch.zeros(int(done.sum()),
                                                          dtype=torch.int32))
        assert torch.equal(ps["count"][~done], count_before[~done] + 1)
        for layer, layer0 in zip(ps["layers"], pstate0["layers"]):
            for name, t in layer.items():
                assert torch.equal(t[done], layer0[name][done])
        assert torch.equal(obs[done][:, :-1],
                           torch.zeros_like(obs[done][:, :-1]))
    assert n_done >= 6
    assert not any(bool(t.any()) for _, t in ptq.tree_tensors(pstate0))


def test_rollout_trajectory_and_fp32_branch():
    env, net, params, benv = _seq_actor("airnav_seq", 5, backend="fp32")
    assert hasattr(benv.reset(torch.Generator(), "cpu")[0], "frames")
    pol = dqn.make_behaviour_policy(benv, net, dqn.DQNConfig())(
        params, {}, torch.tensor(0), torch.tensor(10_000))
    gen = torch.Generator().manual_seed(2)
    state, obs = benv.reset(gen, "cpu")
    state, obs, traj = env_mod.rollout(benv, pol, params, state, obs, gen, 7)
    assert tuple(traj.obs.shape) == (7, 5, 8, 11)
    assert tuple(traj.logits_or_value.shape) == (7, 5, 25)
    assert traj.action.dtype == torch.int32
    want = net.apply(params, traj.obs[3])
    assert torch.equal(traj.logits_or_value[3], want)
    assert torch.equal(traj.next_obs[2], traj.obs[3])


def test_epsilon_one_explores_in_range():
    env, net, params, benv = _seq_actor("catch_seq", 64)
    pol = dqn.make_behaviour_policy(benv, net, dqn.DQNConfig(
        actor_backend="int4", eps_start=1.0, eps_end=1.0))(
        params, {}, torch.tensor(0), torch.tensor(0))
    gen = torch.Generator().manual_seed(3)
    state, obs = benv.reset(gen, "cpu")
    _, _, traj = env_mod.rollout(benv, pol, params, state, obs, gen, 4)
    a = traj.action
    assert int(a.min()) >= 0 and int(a.max()) < env.spec.n_actions
    assert len(torch.unique(a)) == env.spec.n_actions
    assert not torch.equal(a, traj.logits_or_value.argmax(-1).to(a.dtype))


def test_windowed_matches_cached_on_episode():
    """The cached decode agrees with the windowed int8 forward over a
    real episode within the reference's 2e-2, with equal argmax
    (``docs/contracts.md:39``)."""
    env = make("catch_seq")
    net = networks.make_network(env.spec.obs_shape, env.spec.n_actions,
                                transformer=dict(SEQ_NET), device="cpu")
    qp = actorq.pack_actor_params(net.init(torch.Generator().manual_seed(6)),
                                  8)
    gen = torch.Generator().manual_seed(4)
    state, obs = env.reset(gen, 1, "cpu")
    pstate = actorq.seq_cache_zeros(net.seq_cfg, 1, env.spec.max_steps + 1,
                                    device="cpu")
    for _ in range(env.spec.max_steps):
        q_w = actorq.quantized_seq_apply(qp, obs)
        q_c, pstate = actorq.quantized_seq_step(qp, obs[:, -1], pstate,
                                                context=net.seq_cfg.context)
        np.testing.assert_allclose(q_c.numpy(), q_w.numpy(), atol=2e-2)
        assert int(q_c.argmax()) == int(q_w.argmax())
        action = torch.randint(0, 3, (1,), generator=gen)
        state, obs, _, done = env.step(state, action, gen)
        if bool(done.any()):
            break
    assert int(pstate["count"][0]) >= 2


def test_cache_write_index_clamps():
    """Past the last slot the writer clamps as ``dynamic_update_slice``
    does: it writes the last slot instead of indexing out of range."""
    _, net, params, _ = _seq_actor("catch_seq", 3)
    qp = actorq.pack_actor_params(params, 8)
    size = 4
    ps = actorq.seq_cache_zeros(net.seq_cfg, 3, size, device="cpu")
    ps = {**ps, "count": torch.tensor([1, size, size + 5],
                                      dtype=torch.int32)}
    feat = torch.from_numpy(_frame_obs(3, 1, net.seq_cfg.feat_dim, 8)[:, 0])
    _, new = actorq.quantized_seq_step(qp, feat, ps, context=6)
    codes = new["layers"][0]["k_codes"]
    written = codes.abs().sum(-1) > 0                      # (3, size)
    assert written.tolist() == [[False, True, False, False],
                                [False, False, False, True],
                                [False, False, False, True]]
    assert new["count"].tolist() == [2, size + 1, size + 6]
    assert not bool(ps["layers"][0]["k_codes"].any())      # out of place


def test_seq_cache_size_calibration_and_eval():
    env, net, params, _ = _seq_actor("catch_seq", 4)
    size = env.spec.max_steps + 1
    ps = actorq.seq_cache_zeros(net.seq_cfg, 4, size, device="cpu")
    d = net.seq_cfg.d_model
    per_layer = 4 * size * d * 2 + 4 * size * 4 * 2        # codes + scales
    assert actorq.seq_cache_nbytes(ps) == 2 * per_layer + 4 * 4
    qp = actorq.pack_actor_params(params, 4)
    assert actorq.calibrate_actor_cache(qp, torch.zeros(4, 6, 27)) is qp
    ret = env_mod.evaluate(env, actorq.make_act_fn(env.spec), qp,
                           torch.Generator().manual_seed(5), 16,
                           device="cpu")
    assert -1.0 <= float(ret) <= 1.0
    with pytest.raises(ValueError, match="kernel_backend"):
        dqn.make_behaviour_policy(env, net, dqn.DQNConfig(
            kernel_backend="ref"))
