"""Port parity: the QAT site entry points (``kernels.ops.qat_weight_site``
/ ``qat_activation_site``, the composition B5's site kernel replaces on
the card) and B1's plain version at the redesigned kernel's edge rows,
against the JAX package on the CPU.

Tolerances, each with its reason:

* The sites: bitwise (``assert_array_equal``: NaN equals NaN, and -0.0
  equals 0.0), the output and the three observer scalars, against
  ``QATContext.weight`` / ``.activation`` of the JAX package.  Every op is
  a single correctly rounded float32 op in the same order in both
  packages; the JAX side runs eagerly, as its own tests do on the CPU.
  Steps before, at and after ``quant_delay``; uninitialized and
  initialized slots; bits 2, 4, 8; normal, all-zero, all-positive, tie and
  NaN inputs.
* The site gradient: bitwise against autograd through the composition the
  context ran before the site kernel (``observe``, the STE fake quantizer
  and ``torch.where``): the STE through either branch of the gate is the
  identity.
* ``ops.int8_matmul`` on CPU tensors: bitwise against JAX ``ref`` (only
  integer products precede the int32 correction).

Inputs are numpy arrays from a seed, handed to both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import affine as jaffine
from repro.core import fake_quant as jfq
from repro.core.qconfig import QuantConfig as JQuantConfig
from repro.kernels import ops as jops
from repro_torch.core import affine, fake_quant
from repro_torch.core.qconfig import QuantConfig
from repro_torch.kernels import fake_quant as fk
from repro_torch.kernels import int8_matmul, ops

DELAY = 6
STEPS = {"before": DELAY - 1, "at": DELAY, "after": DELAY + 3}
KINDS = ["normal", "zeros", "positive", "ties", "nan"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _site_input(kind, bits, seed, shape=(8, 64)):
    rng = np.random.default_rng(seed)
    if kind == "zeros":
        return np.zeros(shape, np.float32)
    if kind == "positive":
        return rng.uniform(0.5, 2.0, size=shape).astype(np.float32)
    if kind == "ties":
        # range exactly (-32, 32): x / delta = k + 0.5 at every other value
        k = rng.integers(-2 ** (bits - 1), 2 ** (bits - 1), size=shape)
        x = ((k + 0.5) * (64.0 / 2 ** bits)).astype(np.float32)
        x.flat[0], x.flat[1] = -32.0, 32.0
        return x
    x = (rng.normal(size=shape) * 1.7).astype(np.float32)
    if kind == "nan":
        x.flat[rng.integers(0, x.size)] = np.nan
    return x


def _slots(initialized):
    if initialized:
        st = fake_quant.ObserverState(torch.tensor(-1.25), torch.tensor(2.5),
                                      torch.tensor(True))
    else:
        st = fake_quant.ObserverState.init("cpu")
    jst = jfq.ObserverState(jnp.asarray(st.vmin.numpy()),
                            jnp.asarray(st.vmax.numpy()),
                            jnp.asarray(st.initialized.numpy()))
    return st, jst


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("initialized", [False, True],
                         ids=["fresh", "initialized"])
@pytest.mark.parametrize("when", list(STEPS))
def test_activation_site_bitwise_vs_jax(when, initialized, bits, kind):
    step = STEPS[when]
    x = _site_input(kind, bits, seed=bits * 100 + step + len(kind))
    st, jst = _slots(initialized)
    out, nmin, nmax, ninit = ops.qat_activation_site(
        _t(x), st.vmin, st.vmax, st.initialized,
        torch.tensor(step, dtype=torch.int32), DELAY, 0.999, bits)
    jctx = jfq.make_context(JQuantConfig.qat(bits, quant_delay=DELAY),
                            {"s/out": jst}, jnp.asarray(step, jnp.int32))
    want = np.asarray(jctx.activation("s/out", jnp.asarray(x)))
    jnew = jctx.updates["s/out"]
    np.testing.assert_array_equal(out.numpy(), want)
    for got, exp in zip((nmin, nmax, ninit), jnew):
        assert got.shape == () and got.dtype == torch.from_numpy(
            np.array(exp)).dtype
        np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    # the old state is left as it was: the site is functional
    np.testing.assert_array_equal(st.vmin.numpy(), np.asarray(jst.vmin))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("when", list(STEPS))
def test_weight_site_bitwise_vs_jax(when, bits, kind):
    step = STEPS[when]
    w = _site_input(kind, bits, seed=bits * 7 + step, shape=(64, 2)) / 4
    got = ops.qat_weight_site(_t(w), torch.tensor(step), DELAY, bits)
    jctx = jfq.make_context(JQuantConfig.qat(bits, quant_delay=DELAY), {},
                            jnp.asarray(step))
    want = np.asarray(jctx.weight("s/w", jnp.asarray(w)))
    np.testing.assert_array_equal(got.numpy(), want)
    if step < DELAY:
        np.testing.assert_array_equal(got.numpy(), w)


@pytest.mark.parametrize("shape", [(512, 256), (4, 64)], ids=str)
def test_sites_through_the_context_bitwise_vs_jax(shape):
    """``QATContext`` over the site ops against the JAX context over three
    forwards (monitoring, the turn-on, frozen), a stored and a fresh slot."""
    rng = np.random.default_rng(shape[0])
    cfg, jcfg = (QuantConfig.qat(8, quant_delay=2),
                 JQuantConfig.qat(8, quant_delay=2))
    coll, jcoll = {}, {}
    for step in (0, 1, 2, 5):
        x = (rng.normal(size=shape) * (1 + step)).astype(np.float32)
        ctx = fake_quant.make_context(cfg, coll, torch.tensor(step))
        jctx = jfq.make_context(jcfg, jcoll, jnp.asarray(step))
        for name in ("a/out", "b/out"):
            np.testing.assert_array_equal(
                ctx.activation(name, _t(x)).numpy(),
                np.asarray(jctx.activation(name, jnp.asarray(x))))
        np.testing.assert_array_equal(
            ctx.weight("a/w", _t(x)).numpy(),
            np.asarray(jctx.weight("a/w", jnp.asarray(x))))
        coll, jcoll = ctx.merged_collection(), jctx.merged_collection()
        for k in jcoll:
            for g, w in zip(coll[k], jcoll[k]):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))


class _STE(torch.autograd.Function):
    """The straight-through fake quantizer the context composed before the
    site kernel: quantize-dequantize forward, ``g`` to ``w``, nothing to
    the range."""

    @staticmethod
    def forward(ctx, w, vmin, vmax, bits):
        return fk.fake_quant_plain(w, vmin, vmax, bits)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


def _composition_grads(x, w, c, cw, coll, step, delay):
    """Autograd through the sites as the context composed them before the
    site kernel: observe, the STE fake quantizer, torch.where."""
    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    st = coll["s/out"]
    monitoring, enabled = torch.tensor(step < delay), torch.tensor(
        step >= delay)
    new = fake_quant.observe(st, tx, 0.999, monitoring)
    act = torch.where(enabled & new.initialized,
                      _STE.apply(tx, new.vmin, new.vmax, 8), tx)
    lo, hi = torch.aminmax(tw.detach())
    wq = torch.where(enabled, _STE.apply(tw, torch.clamp(lo, max=0.0),
                                         torch.clamp(hi, min=0.0), 8), tw)
    loss = torch.sum(act * _t(c)) + torch.sum(wq * _t(cw))
    return torch.autograd.grad(loss, (tx, tw)), act.detach(), wq.detach()


@pytest.mark.parametrize("step", [0, 3])
def test_site_gradient_bitwise_vs_the_composition(step):
    rng = np.random.default_rng(step)
    x = rng.normal(size=(8, 64)).astype(np.float32)
    w = (rng.normal(size=(64, 64)) / 8).astype(np.float32)
    c = rng.normal(size=(8, 64)).astype(np.float32)
    cw = rng.normal(size=(64, 64)).astype(np.float32)
    coll = {"s/out": fake_quant.ObserverState(
        torch.tensor(-1.0), torch.tensor(2.0), torch.tensor(True))}
    (wgx, wgw), want_act, want_w = _composition_grads(x, w, c, cw, coll,
                                                      step, 1)
    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    ctx = fake_quant.make_context(QuantConfig.qat(8, quant_delay=1), coll,
                                  torch.tensor(step))
    act, wq = ctx.activation("s/out", tx), ctx.weight("s/w", tw)
    assert torch.equal(act.detach(), want_act)
    assert torch.equal(wq.detach(), want_w)
    loss = torch.sum(act * _t(c)) + torch.sum(wq * _t(cw))
    gx, gw = torch.autograd.grad(loss, (tx, tw))
    assert torch.equal(gx, wgx) and torch.equal(gw, wgw)
    assert torch.equal(gx, _t(c)) and torch.equal(gw, _t(cw))
    # no gradient reaches the observer state
    assert all(not t.requires_grad for t in ctx.updates["s/out"])


def test_site_kernel_wrappers_refuse_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        fk.weight_site_cuda(torch.zeros(4), torch.tensor(0), 1, 8)
    with pytest.raises(ValueError, match="CUDA"):
        fk.activation_site_cuda(torch.zeros(4), torch.tensor(0.0),
                                torch.tensor(0.0), torch.tensor(False),
                                torch.tensor(0), 1, 0.999, 8)


def _gemm_inputs(m, k, n, bits, seed):
    rng = np.random.default_rng(seed)
    x_q = rng.integers(-128, 128, size=(m, k)).astype(np.int8)
    half = 2 ** (bits - 1)
    w = rng.integers(-half, half, size=(k, n)).astype(np.int8)
    w_q = np.asarray(jaffine.pack_int4(jnp.asarray(w))) if bits <= 4 else w
    return (x_q, w_q, np.float32(rng.uniform(0.01, 0.1)),
            np.float32(rng.integers(-128, 128)),
            rng.uniform(0.001, 0.05, size=n).astype(np.float32),
            rng.integers(-half, half, size=n).astype(np.float32))


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("mkn", [
    # the wgmma tile's edges: K below, at and past one 32-deep slice and
    # one 64-deep stage; M = 1, 8 (rollout evals) and 65 (two row tiles);
    # N = 2 (the CartPole head), 8 and 25 (the AirNav head); the sequence
    # actor's projections at M = 512
    (8, 4, 2), (1, 31, 8), (8, 32, 25), (64, 33, 8), (65, 64, 25),
    (512, 32, 96), (512, 64, 32)], ids=str)
def test_int8_matmul_plain_at_the_tile_edges_bitwise_vs_jax_ref(bits, mkn):
    m, k, n = mkn
    args = _gemm_inputs(m, k, n, bits, seed=m * 7 + k + n + bits)
    want = jops.int8_matmul(*map(jnp.asarray, args), backend="ref",
                            w_bits=bits)
    got = ops.int8_matmul(*map(torch.tensor, args), w_bits=bits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        int8_matmul.int8_matmul_plain(*map(torch.tensor, args),
                                      w_bits=bits).numpy(),
        np.asarray(want))
    if bits <= 4:   # the packed codes are the JAX package's bytes
        np.testing.assert_array_equal(
            affine.unpack_int4(torch.tensor(args[1]), k).numpy(),
            np.asarray(jaffine.unpack_int4(jnp.asarray(args[1]), k)))
