"""Port parity: the paper's conv actor (per-axis quantization, conv
packing, im2col, the int8 conv actor, the fp32 conv net and its QAT
weight site) against the JAX package on the same numpy inputs.

Tolerances, each with its reason:

* Per-axis affine params, codes, ``ptq_tensor``, ``ptq_simulate``,
  ``ptq_pack`` of a conv kernel and its ``dequantize``: bitwise.  The
  reference reduces order-isomorphic int32 keys on the CPU where the port
  takes ``amin`` / ``amax``; both are exact for finite floats, and only
  the sign of a -0.0 / 0.0 tie can differ, which no param shows.
* im2col patches: bitwise (pure data movement).
* ``fake_quant`` with per-channel ranges and ``fake_quant_self_range``:
  bitwise (the same float32 ops in the same order); the STE gradient is
  the identity.
* The int8 / int4 conv actor: rtol = atol = 1e-5 with equal argmax, as
  ``tests/test_torch_actorq.py`` holds the MLP actor (XLA may contract
  ``+ bias`` into an FMA).
* The fp32 conv net: 1e-5, since the convolution sums in another order
  in another library.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import quarl_atari as jquarl_atari
from repro.core import affine as jaffine
from repro.core import fake_quant as jfq
from repro.core import ptq as jptq
from repro.core.qconfig import QuantConfig as JQuantConfig
from repro.rl import actorq as jactorq
from repro.rl import networks as jnetworks
from repro.rl.env import EnvSpec as JEnvSpec
from repro_torch.configs import quarl_atari
from repro_torch.core import affine, fake_quant, ptq
from repro_torch.core.qconfig import QuantConfig
from repro_torch.rl import actorq, networks
from repro_torch.rl.env import EnvSpec


def _eq(want, got):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _kernel(shape, seed, scale=0.3):
    """A seeded HWIO kernel with a channel of -0.0s and 0.0s, an all-zero
    channel, an all-positive and an all-negative one."""
    w = (np.random.default_rng(seed).normal(size=shape) * scale
         ).astype(np.float32)
    co = shape[-1]
    if co >= 4:
        w[..., 0] = 0.0
        w[..., 0].reshape(-1)[::2] = -0.0
        w[..., 1] = 0.0
        w[..., 2] = np.abs(w[..., 2])
        w[..., 3] = -np.abs(w[..., 3])
    return w


def _jax_net(obs_shape, out_dim, filters, fc_width, seed):
    """The JAX conv net and one set of params for both packages, drawn
    with numpy at the reference's init scales (its eager ``jax.random``
    init compiles for seconds a leaf shape), with non-zero biases so the
    bias add is part of what is compared."""
    jnet = jnetworks.make_network(obs_shape, out_dim, conv_filters=filters,
                                  fc_width=fc_width)
    rng = np.random.default_rng(seed)
    jparams = {}
    for name in sorted(jnet.spec):
        w = jnet.spec[name]["w"]
        scale = w.scale if w.scale is not None else w.shape[-2] ** -0.5
        jparams[name] = {
            "w": jnp.asarray((rng.normal(size=w.shape) * scale
                              ).astype(np.float32)),
            "b": jnp.asarray((rng.normal(size=w.shape[-1:]) * 0.05
                              ).astype(np.float32))}
    tparams = networks.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jnet, jparams, tparams


def _pixels(shape, seed):
    return np.random.default_rng(seed).uniform(0.0, 1.0, size=shape
                                               ).astype(np.float32)


# ---------------------------------------------------------------------------
# per-axis quantization and conv packing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("shape", [(3, 3, 1, 4), (3, 3, 2, 5), (1, 1, 3, 6)])
def test_per_axis_params_codes_and_ptq_tensor_bitwise(shape, bits):
    w = _kernel(shape, seed=bits + shape[2])
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    jp = jaffine.compute_affine_params(jw, bits, axis=3)
    tp = affine.compute_affine_params(tw, bits, axis=3)
    assert tuple(tp.delta.shape) == (1, 1, 1, shape[-1])
    _eq(jp.delta, tp.delta)
    _eq(jp.zero_point, tp.zero_point)
    assert float(tp.delta.reshape(-1)[1]) == 1.0          # all-zero channel
    jq, jqp = jaffine.quantize_to_int(jw, bits, axis=3)
    tq, tqp = affine.quantize_to_int(tw, bits, axis=3)
    _eq(jq, tq)
    _eq(jqp.zero_point, tqp.zero_point)
    _eq(jaffine.ptq_tensor(jw, bits, axis=3), affine.ptq_tensor(tw, bits,
                                                                axis=3))
    _eq(jaffine.ptq_tensor(jw, bits, axis=-1), affine.ptq_tensor(tw, bits,
                                                                 axis=-1))


@pytest.mark.parametrize("spec", ["ptq_int8", "ptq_int4", "ptq_fp16"])
def test_ptq_simulate_on_a_conv_tree_bitwise(spec):
    _, jparams, tparams = _jax_net((6, 6, 2), 3, (4, 5), 8, seed=3)
    got = ptq.ptq_simulate(tparams, QuantConfig.parse(spec))
    want = jax.jit(lambda p: jptq.ptq_simulate(
        p, JQuantConfig.parse(spec)))(jparams)
    for (_, g), w in zip(ptq.tree_tensors(got),
                         jax.tree_util.tree_leaves(want)):
        _eq(w, g)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("shape", [(3, 3, 1, 4), (3, 3, 3, 6)])
def test_ptq_pack_of_a_conv_kernel_bitwise(shape, bits):
    w = _kernel(shape, seed=bits)
    jpk = jptq.ptq_pack({"conv0": {"w": jnp.asarray(w)}},
                        JQuantConfig.ptq_int(bits))["conv0"]["w"]
    tpk = ptq.ptq_pack({"conv0": {"w": torch.from_numpy(w)}},
                       QuantConfig.ptq_int(bits))["conv0"]["w"]
    for field in ("codes", "delta", "zero_point", "col_scale", "col_zero"):
        _eq(getattr(jpk, field), getattr(tpk, field))
    k = shape[0] * shape[1] * shape[2]
    if bits <= 4:          # im2col-transposed and packed; K is odd here
        assert k % 2 == 1 and tpk.orig_shape == shape
        assert tuple(tpk.codes.shape) == ((k + 1) // 2, shape[-1])
    else:
        assert tpk.orig_shape is None and tuple(tpk.codes.shape) == shape
    assert tuple(tpk.col_scale.shape) == (shape[-1],)
    _eq(jpk.unpacked_codes(), tpk.unpacked_codes())
    _eq(jpk.dequantize(), tpk.dequantize())
    assert tuple(tpk.dequantize().shape) == shape
    assert ptq.tree_nbytes({"w": tpk}) == jptq.tree_nbytes({"w": jpk})


# ---------------------------------------------------------------------------
# im2col and the int8 conv actor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("hwc", [(10, 10, 1), (6, 6, 2), (7, 5, 3)])
def test_im2col_is_bitwise_jax_patches(hwc, stride):
    x = _pixels((2,) + hwc, seed=hwc[2] + stride) - 0.5
    want = jax.lax.conv_general_dilated_patches(
        jnp.asarray(x), (3, 3), (stride, stride), padding="SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = actorq.im2col(torch.from_numpy(x), 3, 3, stride)
    assert tuple(got.shape) == tuple(want.shape)
    _eq(want, got)


@pytest.mark.parametrize("backend", ["ref", "interpret"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("bits", [4, 8])
def test_int8_conv2d_matches_jax(bits, stride, backend):
    w = _kernel((3, 3, 2, 6), seed=bits + stride)
    b = np.linspace(-0.1, 0.1, 6).astype(np.float32)
    x = _pixels((3, 6, 6, 2), seed=stride) - 0.25
    cfg = (JQuantConfig.ptq_int(bits), QuantConfig.ptq_int(bits))
    jlayer = jptq.ptq_pack({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                           cfg[0])
    tlayer = ptq.ptq_pack({"w": torch.from_numpy(w),
                           "b": torch.from_numpy(b)}, cfg[1])
    want = np.asarray(jax.jit(lambda layer, x: jactorq.int8_conv2d(
        layer, x, stride, backend=backend))(jlayer, jnp.asarray(x)))
    got = actorq.int8_conv2d(tlayer, torch.from_numpy(x), stride).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


CATCH_NET, GRID_NET = ((10, 10, 1), (4,), 16), ((6, 6, 2), (8, 8), 32)


@pytest.mark.parametrize("backend", ["ref", "interpret"])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("obs_shape,filters,fc", [CATCH_NET, GRID_NET])
def test_quantized_cnn_apply_matches_jax(obs_shape, filters, fc, bits,
                                         backend):
    _, jparams, tparams = _jax_net(obs_shape, 3, filters, fc,
                                   seed=len(filters) + bits)
    x = _pixels((2, 3) + obs_shape, seed=bits)           # leading dims
    jq = jactorq.pack_actor_params(jparams, bits)
    tq = actorq.pack_actor_params(tparams, bits)
    assert actorq.packed_nbytes(tq) == jactorq.packed_nbytes(jq)
    want = np.asarray(jax.jit(lambda q, x: jactorq.quantized_apply(
        q, x, backend=backend))(jq, jnp.asarray(x)))
    got = actorq.quantized_apply(tq, torch.from_numpy(x)).numpy()
    assert got.shape == (2, 3, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    spec_j = JEnvSpec("catch", obs_shape=obs_shape, n_actions=3)
    spec_t = EnvSpec("catch", obs_shape=obs_shape, n_actions=3)
    np.testing.assert_array_equal(
        actorq.make_act_fn(spec_t)(tq, torch.from_numpy(x)).numpy(),
        np.asarray(jax.jit(jactorq.make_act_fn(spec_j, backend=backend))(
            jq, jnp.asarray(x))))


def test_calibration_of_a_conv_cache_is_a_no_op():
    _, jparams, tparams = _jax_net((6, 6, 2), 3, (4,), 16, seed=5)
    tq = actorq.make_actor_cache(tparams, "int8",
                                 calib_obs=torch.from_numpy(
                                     _pixels((4, 6, 6, 2), 1)))
    assert actorq.ACT_QUANT not in tq
    jq = jactorq.make_actor_cache(jparams, "int8",
                                  calib_obs=jnp.asarray(_pixels((4, 6, 6, 2),
                                                                1)))
    assert jactorq.ACT_QUANT not in jq


# ---------------------------------------------------------------------------
# the fp32 conv net
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("obs_shape,filters,fc", [
    ((10, 10, 1), (4,), 16), ((6, 6, 2), (8, 8), 32),
    ((10, 10, 1), None, 128)])
def test_fp32_cnn_apply_matches_jax(obs_shape, filters, fc):
    jnet, jparams, tparams = _jax_net(obs_shape, 3, filters, fc, seed=2)
    x = _pixels((2, 4) + obs_shape, seed=3)
    want = np.asarray(jnet.apply(jfq.NullQATContext(), jparams,
                                 jnp.asarray(x)))
    net = networks.make_network(obs_shape, 3, conv_filters=filters,
                                fc_width=fc, device="cpu")
    got = net.apply(tparams, torch.from_numpy(x)).numpy()
    assert got.shape == (2, 4, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_conv_net_init_follows_the_reference_layout_and_scales():
    net = networks.make_network((10, 10, 1), 3, device="cpu")
    p = net.init(torch.Generator().manual_seed(0))
    jspec = jnetworks.make_network((10, 10, 1), 3).spec
    for name in ("conv0", "conv1", "conv2", "fc", "out"):
        assert tuple(p[name]["w"].shape) == jspec[name]["w"].shape
        assert not bool(p[name]["b"].any())
    assert tuple(p["conv0"]["w"].shape) == (3, 3, 1, 16)
    assert tuple(p["fc"]["w"].shape) == (10 * 10 * 16, 128)
    assert abs(float(p["conv1"]["w"].std()) - 1 / 12.0) < 0.01
    assert float(p["out"]["w"].std()) < 0.02           # head scale 0.01
    again = net.init(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(
        ptq.tree_tensors(p), ptq.tree_tensors(again)))


def test_quarl_atari_configs_are_the_reference_copy():
    for name in ("ATARI_DQN", "POLICY_A", "POLICY_B", "POLICY_C",
                 "DEPLOY_POLICY_I", "DEPLOY_POLICY_II", "DEPLOY_POLICY_III"):
        got, want = getattr(quarl_atari, name), getattr(jquarl_atari, name)
        assert type(got).__name__ == type(want).__name__
        assert vars(got) == vars(want)


# ---------------------------------------------------------------------------
# the QAT conv weight site
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [2, 4, 8])
def test_per_channel_fake_quant_and_self_range_bitwise(bits):
    w = _kernel((3, 3, 2, 6), seed=bits)
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    jmin = jnp.minimum(jnp.min(jw, axis=(0, 1, 2)), 0.0)
    jmax = jnp.maximum(jnp.max(jw, axis=(0, 1, 2)), 0.0)
    tmin = torch.clamp(tw.amin(dim=(0, 1, 2)), max=0.0)
    tmax = torch.clamp(tw.amax(dim=(0, 1, 2)), min=0.0)
    _eq(jmin, tmin)
    _eq(jfq.fake_quant(jw, jmin, jmax, bits),
        fake_quant.fake_quant(tw, tmin, tmax, bits))
    _eq(jfq.fake_quant(jw, jnp.float32(-0.4), jnp.float32(0.7), bits),
        fake_quant.fake_quant(tw, torch.tensor(-0.4), torch.tensor(0.7),
                              bits))
    _eq(jfq.fake_quant_self_range(jw, bits),
        fake_quant.fake_quant_self_range(tw, bits))


def test_fake_quant_gradient_is_the_identity():
    w = torch.from_numpy(_kernel((3, 3, 1, 4), seed=1)).requires_grad_(True)
    vmin = torch.full((4,), -0.2, requires_grad=True)
    vmax = torch.full((4,), 0.2, requires_grad=True)
    g = torch.from_numpy(_kernel((3, 3, 1, 4), seed=2))
    gw, gmin, gmax = torch.autograd.grad(
        fake_quant.fake_quant(w, vmin, vmax, 4), (w, vmin, vmax), g,
        allow_unused=True)
    assert torch.equal(gw, g)
    assert gmin is None and gmax is None
    gs, = torch.autograd.grad(fake_quant.fake_quant_self_range(w, 4), (w,),
                              g)
    assert torch.equal(gs, g)


@pytest.mark.parametrize("step,quantized", [(4, False), (5, True)])
def test_conv_weight_site_respects_the_delay(step, quantized):
    # mirrors tests/test_actorq.py:195-207: before the delay the conv
    # kernel is used as it is, from the delay on it is fake-quantized
    _, jparams, tparams = _jax_net((6, 6, 1), 3, (4,), 8, seed=9)
    layer = {"w": tparams["conv0"]["w"] * 7.3, "b": tparams["conv0"]["b"]}
    x = torch.from_numpy(_pixels((2, 6, 6, 1), 4))
    cfg = QuantConfig.qat(4, quant_delay=5)
    ctx = fake_quant.make_context(cfg, {}, torch.tensor(step))
    assert bool(ctx.monitoring) != quantized
    got = networks.conv2d(ctx, "conv0", layer, x)
    plain = networks.conv2d(fake_quant.NullQATContext(), "conv0", layer, x)
    jctx = jfq.make_context(JQuantConfig.qat(4, quant_delay=5), {}, step)
    jlayer = {"w": jnp.asarray(layer["w"].numpy()),
              "b": jnp.asarray(layer["b"].numpy())}
    want = np.asarray(jnetworks.conv2d(jctx, "conv0", jlayer,
                                       jnp.asarray(x.numpy())))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, plain) != quantized
    assert sorted(ctx.updates) == ["conv0/out"]


def test_conv_qat_gradient_reaches_the_kernel_through_both_branches():
    net = networks.make_network((6, 6, 1), 3, conv_filters=(4,),
                                fc_width=8, device="cpu")
    params = net.init(torch.Generator().manual_seed(1))
    x = torch.from_numpy(_pixels((3, 6, 6, 1), 2))
    for step in (0, 10):
        ctx = fake_quant.make_context(QuantConfig.qat(8, quant_delay=5), {},
                                      torch.tensor(step))
        leaves = ptq.tree_map(lambda t: t.detach().requires_grad_(True),
                              params)
        net.apply(leaves, x, ctx=ctx).sum().backward()
        g = leaves["conv0"]["w"].grad
        assert g is not None and bool(torch.isfinite(g).all()) \
            and bool(g.abs().sum() > 0)
