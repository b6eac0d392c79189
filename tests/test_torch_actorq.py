"""Port parity: the packed ActorQ actor (``repro_torch.rl.actorq``) vs JAX.

* Per-layer (uncalibrated) and calibrated heads of the port agree with the
  JAX actor (``backend="ref"``) within 1e-5 and give the same greedy
  actions; the tolerance is the JAX package's jit-vs-eager one (XLA may
  contract ``+ bias`` into an FMA under jit).
* Inside the port, a cache calibrated on X gives on X bitwise the
  per-layer dynamic path: the static params are the dynamic ones and the
  fused epilogue repeats the per-layer op order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.rl import actorq as jactorq
from repro.rl.env import EnvSpec as JEnvSpec
from repro.rl.networks import make_network
from repro_torch.rl import actorq, networks
from repro_torch.rl.env import EnvSpec


def _both(obs_dim, out_dim, hidden, seed):
    jparams = make_network((obs_dim,), out_dim, hidden=hidden).init(
        jax.random.PRNGKey(seed))
    tparams = networks.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jparams, tparams


def _obs(n, d, seed, scale=2.0):
    return (np.random.default_rng(seed).normal(size=(n, d)) * scale
            ).astype(np.float32)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("hidden", [(16,), (32, 32), (64, 64, 64)])
def test_per_layer_and_calibrated_heads_match_jax(bits, hidden):
    jparams, tparams = _both(9, 25, hidden, seed=len(hidden) + bits)
    obs, calib = _obs(33, 9, 1), _obs(32, 9, 2)
    jq = jactorq.pack_actor_params(jparams, bits)
    tq = actorq.pack_actor_params(tparams, bits)
    assert actorq.packed_nbytes(tq) == jactorq.packed_nbytes(jq)
    jc = jactorq.calibrate_actor_cache(jq, jnp.asarray(calib), backend="ref")
    tc = actorq.calibrate_actor_cache(tq, torch.from_numpy(calib))
    for (dj, zj), (dt, zt) in zip(jc[jactorq.ACT_QUANT],
                                  tc[actorq.ACT_QUANT]):
        np.testing.assert_array_equal(np.asarray(dj), dt.numpy())
        np.testing.assert_array_equal(np.asarray(zj), zt.numpy())
    for jcache, tcache in ((jq, tq), (jc, tc)):
        want = np.asarray(jactorq.quantized_apply(jcache, jnp.asarray(obs),
                                                  backend="ref"))
        got = actorq.quantized_apply(tcache, torch.from_numpy(obs)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    spec_j = JEnvSpec("t", obs_shape=(9,), n_actions=25)
    spec_t = EnvSpec("t", obs_shape=(9,), n_actions=25)
    np.testing.assert_array_equal(
        actorq.make_act_fn(spec_t)(tc, torch.from_numpy(obs)).numpy(),
        np.asarray(jactorq.make_act_fn(spec_j, backend="ref")(
            jc, jnp.asarray(obs))))


@pytest.mark.parametrize("bits", [4, 8])
def test_calibrated_on_x_equals_dynamic_on_x_bitwise(bits):
    _, tparams = _both(4, 3, (32, 16, 8), seed=1)
    x = torch.from_numpy(_obs(50, 4, 2))
    qp = actorq.pack_actor_params(tparams, bits)
    cache = actorq.calibrate_actor_cache(qp, x)
    assert actorq.ACT_QUANT in cache
    assert torch.equal(actorq.quantized_apply(cache, x),
                       actorq.quantized_apply(qp, x))


def test_leading_batch_dims_and_continuous_head():
    _, tparams = _both(5, 2, (16, 16), seed=4)
    qp = actorq.make_actor_cache(tparams, "int8")
    x = torch.from_numpy(_obs(12, 5, 5)).reshape(3, 4, 5)
    out = actorq.quantized_apply(qp, x)
    assert tuple(out.shape) == (3, 4, 2)
    spec = EnvSpec("c", obs_shape=(5,), action_dim=2, action_scale=2.0)
    act = actorq.make_act_fn(spec)(qp, x)
    assert act.dtype == torch.float32 and float(act.abs().max()) <= 2.0


def test_backend_validation_and_unported_caches():
    assert actorq.backend_bits("int4") == 4
    assert actorq.is_quantized("int8") and not actorq.is_quantized("fp32")
    with pytest.raises(ValueError):
        actorq.validate_actor_backend("int2")
    with pytest.raises(ValueError):
        actorq.backend_bits("fp32")
    with pytest.raises(ValueError):
        actorq.pack_actor_params({}, bits=9)
    # conv caches are ported: packed per output channel, dispatched to the
    # conv net, and left uncalibrated (tests/test_torch_conv.py holds them
    # against JAX)
    conv = networks.make_network((5, 5, 1), 3, conv_filters=(2,),
                                 fc_width=4, device="cpu")
    qp = actorq.pack_actor_params(
        conv.init(torch.Generator().manual_seed(0)))
    assert tuple(qp["conv0"]["w"].delta.shape) == (1, 1, 1, 2)
    assert tuple(actorq.quantized_apply(qp, torch.zeros(2, 5, 5, 1)).shape) \
        == (2, 3)
    assert actorq.calibrate_actor_cache(qp, torch.zeros(1, 5, 5, 1)) is qp
    assert tuple(actorq.calib_slice(torch.zeros(10, 3), 4).shape) == (4, 3)
    assert tuple(actorq.calib_slice(torch.zeros(2, 3), 4).shape) == (2, 3)


def test_fp32_module_matches_jax_mlp():
    from repro.core.fake_quant import NullQATContext
    from repro.rl.networks import mlp_apply as jmlp_apply
    jparams, tparams = _both(9, 25, (64, 64), seed=7)
    obs = _obs(9, 9, 8)
    want = np.asarray(jmlp_apply(NullQATContext(), jparams,
                                 jnp.asarray(obs), 2))
    module = networks.MLP(tparams)
    got = module(torch.from_numpy(obs)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert set(module.params()) == {"fc0", "fc1", "out"}
    assert not torch.backends.cuda.matmul.allow_tf32


def test_init_mlp_is_seeded_and_laid_out_k_by_n():
    spec = networks.mlp_spec(9, (256, 256, 256), 25)
    a = networks.init_mlp(spec, torch.Generator().manual_seed(3), "cpu")
    b = networks.init_mlp(spec, torch.Generator().manual_seed(3), "cpu")
    assert tuple(a["fc0"]["w"].shape) == (9, 256)
    assert tuple(a["out"]["w"].shape) == (256, 25)
    assert all(torch.equal(a[k]["w"], b[k]["w"]) for k in a)
    assert float(a["out"]["w"].std()) < 0.02      # out_scale = 0.01
