"""Port parity: quantization-aware training and PTQ evaluation
(``repro_torch.core.fake_quant``, ``kernels.ops.fake_quant*`` and kernel
B5's plain version, ``core.ptq.ptq_simulate``, ``core.metrics``,
``core.qconfig``, the QAT-aware MLP of ``rl.networks``,
``rl.common.eval_params``) vs the JAX package.

Tolerances, each with its reason:

* The fake quantizer, ``observe``, the context's weight and activation
  sites, the STE gradient, ``ptq_simulate`` and ``eval_params``: bitwise.
  Every op is a single correctly rounded float32 op in the same order in
  both packages (divisions by a tensor, round half to even), and the JAX
  side runs its ``ref`` oracle and its Pallas kernel in interpret mode, as
  its own tests do on the CPU.
* The QAT MLP forward: most values within 1e-6, the rest within
  ``FLIP_ATOL``.  ``x @ w`` on XLA:CPU and in torch can differ in the last
  ulp, and where ``x / delta`` of an activation site sits on a rounding
  boundary that moves one fake-quant code by one step, as ROADMAP queue C
  records for the dynamic quantizer.  A moved code moves the head by
  about one activation step times a weight; the flips are counted and
  bounded.

Inputs are numpy arrays from a seed, handed to both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fake_quant as jfq
from repro.core import metrics as jmetrics
from repro.core import ptq as jptq
from repro.core.qconfig import QuantConfig as JQuantConfig
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.fake_quant import fake_quant_pallas
from repro.rl import common as jcommon
from repro.rl.networks import make_network as jmake_network
from repro_torch.core import affine, fake_quant, metrics, ptq
from repro_torch.core.qconfig import QuantConfig, QuantMode
from repro_torch.kernels import fake_quant as fk
from repro_torch.kernels import ops, ref
from repro_torch.rl import common, networks

FLIP_ATOL = 5e-3
SHAPES = [(4, 64), (64, 64), (64, 2), (8, 64), (512, 256), (1,), (7, 13)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _range(x, rng):
    lo = np.float32(min(float(x.min()), 0.0) * rng.uniform(0.5, 1.0))
    hi = np.float32(max(float(x.max()), 0.0) * rng.uniform(0.5, 1.0))
    return lo, hi


# ---------------------------------------------------------------------------
# the fake quantizer: plain version and ops against ref and the Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_fake_quant_with_range_bitwise_vs_jax(shape, bits):
    rng = np.random.default_rng(sum(shape) * 10 + bits)
    x = (rng.normal(size=shape) * rng.uniform(0.1, 3.0)).astype(np.float32)
    lo, hi = _range(x, rng)
    want = np.asarray(jref.fake_quant_with_range_ref(
        jnp.asarray(x), jnp.asarray(lo), jnp.asarray(hi), bits))
    got = fk.fake_quant_plain(_t(x), _t(lo), _t(hi), bits).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        ops.fake_quant_with_range(_t(x), _t(lo), _t(hi), bits).numpy(), want)
    np.testing.assert_array_equal(
        ref.fake_quant_with_range_ref(_t(x), _t(lo), _t(hi), bits).numpy(),
        want)
    if x.size <= 4096:      # the interpret-mode kernel on the small sites
        pal = fake_quant_pallas(jnp.asarray(x.reshape(-1, x.shape[-1])),
                                jnp.asarray(lo), jnp.asarray(hi), bits,
                                interpret=True)
        np.testing.assert_array_equal(np.asarray(pal).reshape(shape), got)


def _degenerate(kind, rng):
    if kind == "zeros":
        return np.zeros((8, 64), np.float32)
    if kind == "positive":
        return rng.uniform(0.5, 2.0, size=(64, 2)).astype(np.float32)
    if kind == "negative":
        return -rng.uniform(0.5, 2.0, size=(7, 13)).astype(np.float32)
    # exact ties: x / delta lands on k + 0.5 (round half to even decides)
    delta = np.float32(0.25)
    k = rng.integers(-100, 100, size=(4, 64)).astype(np.float32)
    return ((k + np.float32(0.5)) * delta).astype(np.float32)


@pytest.mark.parametrize("kind", ["zeros", "positive", "negative", "ties"])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_fake_quant_self_range_degenerate_bitwise_vs_jax(kind, bits):
    x = _degenerate(kind, np.random.default_rng(bits))
    want = np.asarray(jops.fake_quant(jnp.asarray(x), bits, backend="ref"))
    pal = np.asarray(jops.fake_quant(jnp.asarray(x), bits,
                                     backend="interpret"))
    got = ops.fake_quant(_t(x), bits).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pal)
    np.testing.assert_array_equal(
        ref.fake_quant_ref(_t(x), bits).numpy(),
        np.asarray(jref.fake_quant_ref(jnp.asarray(x), bits)))
    np.testing.assert_array_equal(
        affine.ptq_tensor(_t(x), bits).numpy(),
        np.asarray(jref.fake_quant_ref(jnp.asarray(x), bits)))
    if kind == "zeros":
        assert not got.any()


def test_ties_round_half_to_even():
    x = torch.tensor([0.125, 0.375, -0.125, -0.375, 0.0])
    # range (-1, 1), 3 bits: delta 0.25, zero point 4; x / delta = +-0.5,
    # +-1.5 -> codes 4, 6, 4, 2 (ties to even), then dequantized
    out = ops.fake_quant_with_range(x, torch.tensor(-1.0), torch.tensor(1.0),
                                    3)
    assert out.tolist() == [0.0, 0.5, 0.0, -0.5, 0.0]


def test_fake_quant_cuda_refuses_a_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA"):
        fk.fake_quant_cuda(torch.zeros(4), torch.tensor(0.0),
                           torch.tensor(1.0), 8)


# ---------------------------------------------------------------------------
# observers and the QAT context
# ---------------------------------------------------------------------------

def _jstate(st):
    return jfq.ObserverState(jnp.asarray(st.vmin.numpy()),
                             jnp.asarray(st.vmax.numpy()),
                             jnp.asarray(st.initialized.numpy()))


def _same_state(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_observe_bitwise_vs_jax():
    rng = np.random.default_rng(0)
    st, jst = fake_quant.ObserverState.init("cpu"), jfq.ObserverState.init()
    for i in range(12):
        x = (rng.normal(size=(64, 64)) * (1 + i)
             + rng.normal()).astype(np.float32)
        monitoring = i < 8
        st = fake_quant.observe(st, _t(x), 0.999, torch.tensor(monitoring))
        jst = jfq.observe(jst, jnp.asarray(x), 0.999,
                          jnp.asarray(monitoring))
        _same_state(st, jst)
    assert bool(st.initialized)
    # a frozen observer keeps its range
    frozen = fake_quant.observe(st, _t(x * 10), 0.999, torch.tensor(False))
    _same_state(frozen, jst)


@pytest.mark.parametrize("step", [0, 5, 6, 9])
@pytest.mark.parametrize("bits", [4, 8])
def test_qat_context_sites_bitwise_vs_jax(step, bits):
    """Before the delay of 6 (steps 0, 5) the sites observe and pass
    through; from it on weights and activations are fake-quantized with
    frozen ranges."""
    rng = np.random.default_rng(step * 10 + bits)
    cfg = QuantConfig.qat(bits, quant_delay=6)
    jcfg = JQuantConfig.qat(bits, quant_delay=6)
    coll = {"a/out": fake_quant.ObserverState(
        torch.tensor(-0.5), torch.tensor(1.5), torch.tensor(True))}
    jcoll = {"a/out": _jstate(coll["a/out"])}
    w = rng.normal(size=(64, 64)).astype(np.float32) / 8
    x = (rng.normal(size=(64, 64)) * 0.8).astype(np.float32)
    ctx = fake_quant.make_context(cfg, coll, torch.tensor(step))
    jctx = jfq.make_context(jcfg, jcoll, jnp.asarray(step))
    np.testing.assert_array_equal(ctx.weight("a/w", _t(w)).numpy(),
                                  np.asarray(jctx.weight("a/w",
                                                         jnp.asarray(w))))
    for name in ("a/out", "b/out"):       # a stored slot and a fresh one
        got = ctx.activation(name, _t(x)).numpy()
        want = np.asarray(jctx.activation(name, jnp.asarray(x)))
        np.testing.assert_array_equal(got, want)
    merged = ctx.merged_collection()
    jmerged = jctx.merged_collection()
    assert sorted(merged) == sorted(jmerged)
    for k in merged:
        _same_state(merged[k], jmerged[k])
    if step < 6:
        np.testing.assert_array_equal(ctx.weight("a/w", _t(w)).numpy(), w)


def test_prefix_ctx_names_the_sites():
    ctx = fake_quant.make_context(QuantConfig.qat(8, quant_delay=5), {},
                                  torch.tensor(0))
    pre = common.PrefixCtx(ctx, "actor/")
    x = torch.randn(4, 3)
    assert torch.equal(pre.activation("fc0/out", x), x)  # monitoring
    assert torch.equal(pre.weight("fc0/w", x), x)
    assert sorted(pre.merged_collection()) == ["actor/fc0/out"]
    assert pre.config.is_qat and not bool(pre.enabled)


def test_null_context_and_recorder():
    null = fake_quant.make_context(QuantConfig.none(), None, 0)
    x = torch.randn(3, 4)
    assert null.weight("w", x) is x and null.activation("a", x) is x
    assert null.merged_collection() == {} and null.enabled is False
    params = networks.init_mlp(networks.mlp_spec(4, (8, 8), 2),
                               torch.Generator().manual_seed(0), "cpu")
    obs = fake_quant.discover_observers(
        QuantConfig.qat(8), lambda rec: networks.mlp_apply(
            params, torch.zeros(2, 4), ctx=rec))
    assert sorted(obs) == ["fc0/out", "fc1/out", "out/out"]
    assert all(not bool(o.initialized) for o in obs.values())


def test_ste_gradient_bitwise_vs_jax():
    """Identity to the weight and the activation, nothing to the range,
    through ``torch.autograd`` and ``jax.grad`` alike, quantization on."""
    rng = np.random.default_rng(3)
    w = rng.normal(size=(64, 64)).astype(np.float32) / 8
    x = rng.normal(size=(8, 64)).astype(np.float32)
    c = rng.normal(size=(8, 64)).astype(np.float32)
    cw = rng.normal(size=(64, 64)).astype(np.float32)
    coll = {"s/out": fake_quant.ObserverState(
        torch.tensor(-1.0), torch.tensor(2.0), torch.tensor(True))}
    jcoll = {"s/out": _jstate(coll["s/out"])}

    def jloss(w, x):
        ctx = jfq.make_context(JQuantConfig.qat(8, quant_delay=1), jcoll, 3)
        return jnp.sum(ctx.weight("s/w", w) * cw) \
            + jnp.sum(ctx.activation("s/out", x) * c)
    jgw, jgx = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(w), jnp.asarray(x))
    tw, tx = _t(w).requires_grad_(), _t(x).requires_grad_()
    ctx = fake_quant.make_context(QuantConfig.qat(8, quant_delay=1), coll,
                                  torch.tensor(3))
    loss = torch.sum(ctx.weight("s/w", tw) * _t(cw)) \
        + torch.sum(ctx.activation("s/out", tx) * _t(c))
    gw, gx = torch.autograd.grad(loss, (tw, tx))
    np.testing.assert_array_equal(gw.numpy(), np.asarray(jgw))
    np.testing.assert_array_equal(gx.numpy(), np.asarray(jgx))
    np.testing.assert_array_equal(gw.numpy(), cw)
    # no gradient reaches an observed range
    lo, hi = torch.tensor(-1.0, requires_grad=True), torch.tensor(
        2.0, requires_grad=True)
    ctx = fake_quant.make_context(
        QuantConfig.qat(8, quant_delay=1),
        {"s/out": fake_quant.ObserverState(lo, hi, torch.tensor(True))},
        torch.tensor(3))
    out = ctx.activation("s/out", tx)
    assert out.grad_fn is not None and lo.grad is None
    torch.sum(out).backward()
    assert lo.grad is None and hi.grad is None


# ---------------------------------------------------------------------------
# PTQ simulation, eval params, metrics, config
# ---------------------------------------------------------------------------

def _jax_params(seed, hidden=(64, 64)):
    jnet = jmake_network((4,), 2, hidden=hidden)
    jparams = jnet.init(jax.random.PRNGKey(seed))
    return jnet, jparams, networks.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu")


def _same_tree(got, want):
    for k in want:
        for leaf in want[k]:
            np.testing.assert_array_equal(got[k][leaf].numpy(),
                                          np.asarray(want[k][leaf]))


@pytest.mark.parametrize("spec", ["ptq_int8", "ptq_int4", "ptq_int2",
                                  "ptq_fp16", "none"])
def test_ptq_simulate_bitwise_vs_jax(spec):
    _, jparams, params = _jax_params(1)
    jparams = jax.tree_util.tree_map(lambda a: a * 3.0 + 0.01, jparams)
    params = ptq.tree_map(lambda a: a * 3.0 + 0.01, params)
    got = ptq.ptq_simulate(params, QuantConfig.parse(spec))
    want = jptq.ptq_simulate(jparams, JQuantConfig.parse(spec))
    _same_tree(got, want)


@pytest.mark.parametrize("spec", ["qat8", "qat4", "ptq_int8", "none"])
def test_eval_params_bitwise_vs_jax(spec):
    _, jparams, params = _jax_params(2)
    got = common.eval_params(params, QuantConfig.parse(spec))
    want = jcommon.eval_params(jparams, JQuantConfig.parse(spec))
    _same_tree(got, want)


def test_per_axis_conv_raises():
    # per-axis (conv) quantization is ported: per output channel, bitwise
    # against JAX here and across conv trees in tests/test_torch_conv.py
    from repro.core import affine as jaffine
    w = np.random.default_rng(0).normal(size=(3, 3, 2, 4)).astype(
        np.float32)
    w[..., 1] = 0.0
    np.testing.assert_array_equal(
        affine.ptq_tensor(torch.from_numpy(w), 8, axis=3).numpy(),
        np.asarray(jaffine.ptq_tensor(jnp.asarray(w), 8, axis=3)))
    tree = {"conv0": {"w": torch.from_numpy(w)}}
    _same_tree(ptq.ptq_simulate(tree, QuantConfig.ptq_int(8)),
               jptq.ptq_simulate({"conv0": {"w": jnp.asarray(w)}},
                                 JQuantConfig.ptq_int(8)))
    _same_tree(common.eval_params(tree, QuantConfig.qat(8)),
               jcommon.eval_params({"conv0": {"w": jnp.asarray(w)}},
                                   JQuantConfig.qat(8)))


def test_metrics_match_jax():
    _, jparams, params = _jax_params(3)
    got = metrics.weight_distribution_stats(params)
    want = jmetrics.weight_distribution_stats(jparams)
    assert got == pytest.approx(want, rel=1e-6, abs=1e-7)
    assert metrics.weight_distribution_stats({}) == \
        jmetrics.weight_distribution_stats({})
    for a, b in ((100.0, 90.0), (-5.0, 3.0), (0.0, 2.0)):
        assert metrics.relative_error(a, b) == jmetrics.relative_error(a, b)


@pytest.mark.parametrize("spec", ["none", "fp32", "ptq_fp16", "fp16",
                                  "ptq_int8", "ptq_int4", "qat8",
                                  "qat4:delay=1000", "QAT2:delay=7"])
def test_quant_config_parse_and_label_match_jax(spec):
    got, want = QuantConfig.parse(spec), JQuantConfig.parse(spec)
    assert got.label() == want.label() and got.bits == want.bits
    assert got.mode.value == want.mode.value
    assert (got.quant_delay, got.quantize_activations) == \
        (want.quant_delay, want.quantize_activations)
    assert (got.is_qat, got.is_ptq, got.enabled) == \
        (want.is_qat, want.is_ptq, want.enabled)
    assert str(QuantMode.QAT) == "qat"
    with pytest.raises(ValueError, match="unknown"):
        QuantConfig.parse("int3")


# ---------------------------------------------------------------------------
# the QAT MLP forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step", [10, 40])
@pytest.mark.parametrize("bits", [4, 8])
def test_qat_mlp_forward_matches_jax_up_to_flips(step, bits):
    """Observers from a monitoring forward in each package (within an
    ulp), then, from the same ranges, a forward on a new batch before
    (step 10) and after (step 40) the delay of 20."""
    jnet, jparams, params = _jax_params(4 + bits)
    rng = np.random.default_rng(step + bits)
    cfg = QuantConfig.qat(bits, quant_delay=20)
    jcfg = JQuantConfig.qat(bits, quant_delay=20)
    warm = (rng.normal(size=(64, 4)) * 0.5).astype(np.float32)
    ctx = fake_quant.make_context(cfg, {}, torch.tensor(0))
    networks.mlp_apply(params, _t(warm), ctx=ctx)
    jctx = jfq.make_context(jcfg, {}, jnp.asarray(0))
    jnet.apply(jctx, jparams, jnp.asarray(warm))
    coll, jcoll = ctx.merged_collection(), jctx.merged_collection()
    assert sorted(coll) == sorted(jcoll)
    for k in coll:      # the layer outputs' ranges, an ulp apart at most
        for g, w in zip(coll[k], jcoll[k]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    jcoll = {k: _jstate(v) for k, v in coll.items()}   # the same ranges
    x = (rng.normal(size=(64, 4)) * 0.5).astype(np.float32)
    ctx = fake_quant.make_context(cfg, coll, torch.tensor(step))
    got = networks.mlp_apply(params, _t(x), ctx=ctx).numpy()
    jctx = jfq.make_context(jcfg, jcoll, jnp.asarray(step))
    want = np.asarray(jnet.apply(jctx, jparams, jnp.asarray(x)))
    diff = np.abs(got - want)
    flips = int((diff > 1e-6).sum())
    print(f"QAT MLP bits={bits} step={step}: {flips} of {diff.size} "
          f"values off by more than 1e-6 (max {diff.max():.3g})")
    assert diff.max() <= FLIP_ATOL
    assert flips <= diff.size // 8
    assert got.shape == (64, 2)
