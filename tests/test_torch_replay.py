"""Port parity: the replay variants of the actor-learner topologies
(``repro_torch.rl.buffer``: sharded, double buffer, prioritized sum-tree)
and the prioritized learner step, against the JAX package.

Tolerances, each with its reason:

* The sum-tree (set, total, leaves, find), priorities, IS weights, the
  sharded writes and gathers: bitwise.  The tree is repaired pair by pair
  in the reference's order, and ``x ** y`` repeats the C library's
  ``powf`` that XLA:CPU calls (``buffer._powf``).
* The PER-weighted TD update from the same JAX state and batch: loss,
  ``|td|`` and the new params within 1e-5 (the matmuls sum in another
  order, as in ``tests/test_torch_train.py``).

Each test names the reference test it mirrors.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.rl import buffer as jrb
from repro.rl import common as jcommon
from repro.rl import dqn as jdqn
from repro.rl.envs import make as jmake
from repro.rl.networks import make_network as jmake_network
from repro_torch.core import ptq
from repro_torch.rl import buffer as rb
from repro_torch.rl import common, dqn, networks
from repro_torch.rl.envs import make


def _t(a):
    return torch.from_numpy(np.array(a))


def _same(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _transitions(rng, lead, obs_dim=3):
    """Random transitions with leading dims ``lead``, as numpy."""
    n = int(np.prod(lead))
    return (rng.normal(size=lead + (obs_dim,)).astype(np.float32),
            rng.integers(0, 2, size=lead).astype(np.int32),
            rng.normal(size=lead).astype(np.float32),
            (rng.uniform(size=lead) < 0.1).astype(np.float32),
            (rng.normal(size=n * obs_dim).astype(np.float32)
             .reshape(lead + (obs_dim,))))


def _both_batches(tr):
    return (rb.Transition(*(_t(x) for x in tr)),
            jrb.Transition(*(jnp.asarray(x) for x in tr)))


def _same_state(got, want):
    for (_, a), b in zip(ptq.tree_tensors(got),
                         jax.tree_util.tree_leaves(want)):
        _same(a, b)


# ---------------------------------------------------------------------------
# the sum-tree
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("capacity", [3, 8, 17, 100, 2500])
def test_sum_tree_ops_bitwise_vs_jax(capacity):
    """Mirrors test_replay_properties.py::
    test_total_mass_equals_root_after_arbitrary_ops: after a sequence of
    leaf writes the tree, its root and leaves are bitwise JAX's, and the
    descent finds the same leaves for the same masses."""
    rng = np.random.default_rng(capacity)
    size = rb._tree_size(capacity)
    assert size == jrb._tree_size(capacity)
    tree, jtree = torch.zeros(2 * size), jnp.zeros(2 * size)
    for _ in range(6):
        # one batch shape throughout: JAX compiles the repair loop once
        idx = rng.choice(capacity, size=min(capacity, 16), replace=False)
        vals = (np.abs(rng.normal(size=idx.shape)) * 3.0
                + 1e-6).astype(np.float32)
        tree = rb.sum_tree_set(tree, _t(idx), _t(vals))
        jtree = jrb.sum_tree_set(jtree, jnp.asarray(idx, jnp.int32),
                                 jnp.asarray(vals))
        _same(tree, jtree)
    _same(rb.sum_tree_total(tree), jrb.sum_tree_total(jtree))
    _same(rb.sum_tree_leaves(tree), jrb.sum_tree_leaves(jtree))
    u = (rng.uniform(size=256).astype(np.float32)
         * np.asarray(jrb.sum_tree_total(jtree))).astype(np.float32)
    got = rb.sum_tree_find(tree, _t(u))
    _same(got, jrb.sum_tree_find(jtree, jnp.asarray(u)))
    assert bool((rb.sum_tree_leaves(tree)[got] > 0).all())


@pytest.mark.parametrize("alpha", [0.6, 1.0, 0.3])
def test_per_add_and_priorities_bitwise_vs_jax(alpha):
    """Mirrors test_replay_properties.py::
    test_total_mass_anchor_deterministic: writes at max priority (with a
    wrap around the cursor), pushed ``(|td| + eps) ** alpha`` priorities
    and the running max are bitwise JAX's."""
    rng = np.random.default_rng(int(alpha * 10))
    st, jst = rb.per_init(10, (3,), device="cpu"), jrb.per_init(10, (3,))
    for _ in range(3):                 # 5, 10, then a wrap to 15
        batch, jbatch = _both_batches(_transitions(rng, (5,)))
        st, jst = rb.per_add(st, batch), jrb.per_add(jst, jbatch)
        _same_state(st, jst)
        idx = rng.choice(int(st.replay.size), size=4, replace=False)
        td = (rng.normal(size=4) * 2.0).astype(np.float32)
        st = rb.per_update_priorities(st, _t(idx), _t(td), alpha)
        jst = jrb.per_update_priorities(jst, jnp.asarray(idx, jnp.int32),
                                        jnp.asarray(td), alpha)
        _same_state(st, jst)


@pytest.mark.parametrize("beta", [0.4, 0.7, 1.0])
@pytest.mark.parametrize("fill", [1, 6, 64])
def test_is_weights_and_sample_bitwise_vs_jax(beta, fill):
    """Mirrors test_replay_properties.py::
    test_is_weights_uniform_at_equal_priorities_and_beta_scaling: for
    JAX's sampled slots the IS weights are bitwise JAX's, and JAX's
    uniforms, scaled by the root, pick the same slots, transitions and
    weights (``per_sample_at``)."""
    rng = np.random.default_rng(fill)
    st, jst = rb.per_init(64, (3,), device="cpu"), jrb.per_init(64, (3,))
    batch, jbatch = _both_batches(_transitions(rng, (fill,)))
    st, jst = rb.per_add(st, batch), jrb.per_add(jst, jbatch)
    td = (np.abs(rng.normal(size=fill)) * 4.0).astype(np.float32)
    st = rb.per_update_priorities(st, torch.arange(fill), _t(td), 0.6)
    jst = jrb.per_update_priorities(jst, jnp.arange(fill), jnp.asarray(td),
                                    0.6)
    key = jax.random.PRNGKey(fill)
    jb, jidx, jw = jrb.per_sample(jst, key, 32, jnp.float32(beta))
    w = rb.is_weights(st, _t(np.asarray(jidx)).to(torch.int64),
                      torch.tensor(beta, dtype=torch.float32))
    _same(w, jw)
    u = np.asarray(jax.random.uniform(key, (32,)) * jnp.maximum(
        jrb.sum_tree_total(jst.tree), 1e-12))
    b, idx, w2 = rb.per_sample_at(st, _t(u), torch.tensor(beta))
    _same(idx, jidx)
    _same(w2, jw)
    for got, want in zip(b, jb):
        _same(got, want)


@pytest.mark.parametrize("updates", [0, 50, 100, 250, 1234])
def test_per_beta_bitwise_vs_jax(updates):
    """Mirrors test_prioritized_replay.py::
    test_is_beta_anneals_on_learner_update_counter: beta anneals on the
    learner-update counter, bitwise JAX's."""
    cfg = dqn.DQNConfig(is_beta=0.4, is_beta_anneal_updates=1000)
    state = common.TrainState(params={}, opt=(), observers={},
                              step=torch.tensor(10 * updates + 999),
                              extras=dqn.DQNExtras(
                                  (), (), torch.tensor(updates,
                                                       dtype=torch.int32)))
    jstate = jcommon.TrainState(params={}, opt=(), observers={},
                                step=jnp.asarray(0), extras=jdqn.DQNExtras(
                                    (), (), jnp.asarray(updates, jnp.int32)))
    jcfg = jdqn.DQNConfig(is_beta=0.4, is_beta_anneal_updates=1000)
    _same(common.per_beta(state, cfg), jcommon.per_beta(jstate, jcfg))


@pytest.mark.parametrize("n_add", [0, 1, 3, 5])
def test_per_sample_never_returns_unwritten_slot(n_add):
    """Mirrors test_replay_properties.py::
    test_per_sample_unwritten_anchor_deterministic (inside the port)."""
    rng = np.random.default_rng(n_add)
    st = rb.per_init(8, (3,), device="cpu")
    if n_add:
        st = rb.per_add(st, rb.Transition(*(_t(x) for x in _transitions(
            rng, (n_add,)))))
    for seed in range(4):
        _, idx, w = rb.per_sample(st, torch.Generator().manual_seed(seed),
                                  128, 0.4)
        assert int(idx.min()) >= 0 and int(idx.max()) < max(n_add, 1)
        assert bool(torch.isfinite(w).all())


def test_sample_distribution_matches_priorities():
    """Mirrors test_replay_properties.py::
    test_sample_distribution_anchor_deterministic (inside the port): the
    sampled slots follow the normalised priorities (chi-squared), and a
    sampled batch carries its slots' transitions."""
    st = rb.per_init(8, (2,), device="cpu")
    r = torch.arange(8, dtype=torch.float32)
    st = rb.per_add(st, rb.Transition(r[:, None].repeat(1, 2),
                                      r.to(torch.int32), r,
                                      torch.zeros(8), r[:, None] + 0.5))
    td = torch.tensor([8.0, 4.0, 2.0, 1.0, 1.0, 2.0, 4.0, 8.0])
    st = rb.per_update_priorities(st, torch.arange(8), td, 1.0)
    gen = torch.Generator().manual_seed(0)
    _, idx, _ = rb.per_sample(st, gen, 60_000, 1.0)
    counts = np.bincount(idx.numpy(), minlength=8).astype(np.float64)
    leaves = rb.sum_tree_leaves(st.tree)[:8].numpy()
    expected = leaves / leaves.sum() * counts.sum()
    assert float(((counts - expected) ** 2 / expected).sum()) < 40.0
    batch, idx, _ = rb.per_sample(st, gen, 64, 1.0)
    assert torch.equal(batch.action.to(torch.int64), idx)


# ---------------------------------------------------------------------------
# the sharded layout
# ---------------------------------------------------------------------------

def test_sharded_add_bitwise_vs_jax():
    """Mirrors test_actor_learner.py::
    test_sharded_add_matches_independent_shards: per-shard writes at each
    shard's own cursor (with a wrap) are bitwise JAX's vmapped add."""
    rng = np.random.default_rng(0)
    st = rb.replay_init_sharded(3, 8, (3,), device="cpu")
    jst = jrb.replay_init_sharded(3, 8, (3,))
    for n in (5, 5, 2):
        batch, jbatch = _both_batches(_transitions(rng, (3, n)))
        st = rb.replay_add_sharded(st, batch)
        jst = jrb.replay_add_sharded(jst, jbatch)
        _same_state(st, jst)
    _same(rb.replay_total_size(st), jrb.replay_total_size(jst))


def test_sharded_sample_given_indices_vs_jax():
    """Mirrors test_actor_learner.py::
    test_sharded_sample_draws_from_own_shard: each shard is sampled from
    its own written prefix (one draw of shape (shards, per_shard)), and
    given the same indices the batch is JAX's gather, bitwise."""
    rng = np.random.default_rng(1)
    st = rb.replay_init_sharded(2, 16, (3,), device="cpu")
    jst = jrb.replay_init_sharded(2, 16, (3,))
    batch, jbatch = _both_batches(_transitions(rng, (2, 6)))
    batch = batch._replace(reward=torch.stack([torch.zeros(6),
                                               torch.ones(6)]))
    jbatch = jbatch._replace(reward=jnp.stack([jnp.zeros(6), jnp.ones(6)]))
    st = rb.replay_add_sharded(st, batch)
    jst = jrb.replay_add_sharded(jst, jbatch)
    idx = rb.sample_indices(st.size[:, None],
                            torch.Generator().manual_seed(3), (2, 40))
    got = rb.replay_sample_sharded(st, torch.Generator().manual_seed(3), 40)
    assert int(idx.max()) < 6 and tuple(got.reward.shape) == (2, 40)
    assert bool((got.reward[0] == 0).all() and (got.reward[1] == 1).all())
    want = jax.tree_util.tree_map(
        lambda b: jnp.stack([b[i][jnp.asarray(idx[i].numpy())]
                             for i in range(2)]), jst.data)
    for a, b in zip(got, want):
        _same(a, b)


def test_replay_sharding_round_trip_vs_jax():
    """Mirrors test_actor_learner.py::test_replay_sharding_round_trip:
    stacking independent buffers is JAX's stack bitwise, and unstacking
    gives them back."""
    rng = np.random.default_rng(2)
    shards, jshards = [], []
    for i in range(4):
        s = rb.replay_init(8, (3,), device="cpu")
        js = jrb.replay_init(8, (3,))
        batch, jbatch = _both_batches(_transitions(rng, (5 + i,)))
        shards.append(rb.replay_add_batch(s, batch))
        jshards.append(jrb.replay_add_batch(js, jbatch))
    stacked = rb.replay_stack(shards)
    _same_state(stacked, jrb.replay_stack(jshards))
    assert tuple(stacked.size.shape) == (4,)
    assert int(rb.replay_total_size(stacked)) == 5 + 6 + 7 + 8
    for orig, back in zip(shards, rb.replay_unstack(stacked)):
        for (_, a), (_, b) in zip(ptq.tree_tensors(orig),
                                  ptq.tree_tensors(back)):
            assert torch.equal(a, b)


def test_per_sharded_ops_bitwise_vs_jax():
    """Mirrors test_replay_properties.py::
    test_sharded_ops_match_independent_shards: sharded PER init, add,
    priority push and sample (JAX's per-shard uniforms) are bitwise JAX's
    vmapped ones, IS weights normalised per shard."""
    rng = np.random.default_rng(3)
    st = rb.per_init_sharded(2, 8, (3,), device="cpu")
    jst = jrb.per_init_sharded(2, 8, (3,))
    batch, jbatch = _both_batches(_transitions(rng, (2, 5)))
    st, jst = rb.per_add_sharded(st, batch), jrb.per_add_sharded(jst, jbatch)
    idx = np.asarray([[0, 2], [1, 3]])
    td = np.asarray([[1.0, 2.0], [3.0, 0.5]], np.float32)
    st = rb.per_update_priorities_sharded(st, _t(idx), _t(td), 0.6)
    jst = jrb.per_update_priorities_sharded(jst, jnp.asarray(idx),
                                            jnp.asarray(td), 0.6)
    _same_state(st, jst)
    keys = jax.random.split(jax.random.PRNGKey(4), 2)
    jb, jidx, jw = jrb.per_sample_sharded(jst, keys, 16, 0.5)
    u = np.stack([np.asarray(jax.random.uniform(k, (16,)) * jnp.maximum(
        jst.tree[i, 1], 1e-12)) for i, k in enumerate(keys)])
    b, got_idx, w = rb.per_sample_at(st, _t(u), torch.tensor(0.5))
    _same(got_idx, jidx)
    _same(w, jw)
    for a, want in zip(b, jb):
        _same(a, want)
    # the sampler proper draws each shard from its own written prefix
    _, idx2, w2 = rb.per_sample_sharded(st, torch.Generator().manual_seed(0),
                                        16, 0.5)
    assert tuple(idx2.shape) == (2, 16) and int(idx2.max()) < 5
    assert torch.allclose(w2.amax(-1), torch.ones(2))


def test_per_stack_unstack_round_trip():
    """Mirrors test_replay_properties.py::
    test_sharded_stack_unstack_round_trip: trees survive the stacked
    layout bitwise, and each shard's root is its own."""
    rng = np.random.default_rng(4)
    shards = []
    for i in range(3):
        s = rb.per_init(8, (3,), device="cpu")
        s = rb.per_add(s, rb.Transition(*(_t(x) for x in _transitions(
            rng, (i + 2,)))))
        shards.append(rb.per_update_priorities(
            s, torch.zeros(1, dtype=torch.int64), torch.full((1,), 1.0 + i),
            0.6))
    stacked = rb.per_stack(shards)
    assert tuple(stacked.tree.shape) == (3, 16)
    for i, (orig, back) in enumerate(zip(shards, rb.per_unstack(stacked))):
        for (_, a), (_, b) in zip(ptq.tree_tensors(orig),
                                  ptq.tree_tensors(back)):
            assert torch.equal(a, b)
        assert torch.equal(stacked.tree[i, 1], rb.sum_tree_total(orig.tree))


# ---------------------------------------------------------------------------
# the double buffer
# ---------------------------------------------------------------------------

def test_double_buffer_slots_are_independent():
    """Mirrors test_async_actor_learner.py::
    test_double_buffer_slots_are_independent."""
    db = rb.double_buffer_init(rb.replay_init_sharded, 2, 8, (3,),
                               device="cpu")
    batch = rb.Transition(torch.ones(2, 5, 3),
                          torch.zeros(2, 5, dtype=torch.int32),
                          torch.ones(2, 5), torch.zeros(2, 5),
                          torch.ones(2, 5, 3))
    db = db._replace(write=rb.replay_add_sharded(db.write, batch))
    assert int(rb.replay_total_size(db.write)) == 10
    assert int(rb.replay_total_size(db.read)) == 0
    assert int(rb.double_buffer_total_size(db)) == 10
    ptrs = [{t.data_ptr() for _, t in ptq.tree_tensors(slot)}
            for slot in db]
    assert not ptrs[0] & ptrs[1]


def test_double_buffer_swap_is_reference_exchange():
    """Mirrors test_async_actor_learner.py::
    test_double_buffer_swap_is_reference_exchange."""
    db = rb.double_buffer_init(rb.per_init_sharded, 1, 4, (2,),
                               device="cpu")
    swapped = rb.double_buffer_swap(db)
    assert swapped.read is db.write and swapped.write is db.read
    back = rb.double_buffer_swap(swapped)
    assert back.read is db.read and back.write is db.write


# ---------------------------------------------------------------------------
# the prioritized TD update
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("updates,fill", [(0, 100), (99, 600)])
def test_prioritized_td_update_matches_jax(updates, fill):
    """Mirrors test_prioritized_replay.py::
    test_priority_exponent_nonzero_changes_sampling's learner step: from
    the same JAX state (carried by ``state_from_jax``, sum-tree included)
    and the same IS-weighted batch, ``td_update(weights=...)`` gives
    JAX's loss, ``|td|`` and params within 1e-5 (warmup holding the
    params at the first row, learning and a target sync at the second)."""
    rng = np.random.default_rng(updates)
    jenv, jnet = jmake("cartpole"), jmake_network((4,), 2)
    jcfg = jdqn.DQNConfig(replay="prioritized")
    jst = jdqn.init(jax.random.PRNGKey(updates), jenv, jnet, jcfg)
    tr = _transitions(rng, (fill,), obs_dim=4)
    per = jrb.per_add(jst.extras.replay,
                      jrb.Transition(*(jnp.asarray(x) for x in tr)))
    per = jrb.per_update_priorities(
        per, jnp.arange(fill),
        jnp.asarray(np.abs(rng.normal(size=fill)), jnp.float32), 0.6)
    jst = jst._replace(extras=jst.extras._replace(
        replay=per, updates=jnp.asarray(updates, jnp.int32)))
    beta = jcommon.per_beta(jst, jcfg)
    jbatch, jidx, jw = jrb.per_sample(per, jax.random.PRNGKey(7), 64, beta)
    jnew, (jloss, jtd) = jdqn.make_td_update(jenv, jnet, jcfg)(
        jst, jbatch, per.replay.size, weights=jw)

    st = common.state_from_jax(jax.tree_util.tree_map(np.asarray, jst),
                               "cpu")
    assert isinstance(st.extras.replay, rb.PrioritizedReplayState)
    _same_state(st.extras.replay, jst.extras.replay)
    env = make("cartpole")
    net = networks.make_network((4,), 2, device="cpu")
    cfg = dqn.DQNConfig(replay="prioritized")
    idx = _t(np.asarray(jidx)).to(torch.int64)
    w = rb.is_weights(st.extras.replay, idx, common.per_beta(st, cfg))
    _same(w, jw)
    batch = rb.Transition(*(x[idx] for x in st.extras.replay.replay.data))
    new, (loss, td) = dqn.make_td_update(env, net, cfg)(
        st, batch, st.extras.replay.replay.size, weights=w)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(td.numpy(), np.asarray(jtd), rtol=1e-5,
                               atol=1e-5)
    for (_, got), want in zip(ptq.tree_tensors(new.params),
                              jax.tree_util.tree_leaves(jnew.params)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
    assert int(new.extras.updates) == int(jnew.extras.updates)
    # and the priority push of those |td| lands within the same bound
    pushed = rb.per_update_priorities(st.extras.replay, idx, td, 0.6)
    jpushed = jrb.per_update_priorities(per, jidx, jtd, 0.6)
    np.testing.assert_allclose(pushed.tree.numpy(),
                               np.asarray(jpushed.tree), rtol=1e-5)
