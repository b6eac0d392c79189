"""Port parity: the recurrent blocks (``repro_torch.models.recurrent``).

The same weights and inputs (numpy, from a seed) go through the JAX
package and the port on the CPU.  Held:

* ``causal_conv1d`` with and without decode state: bitwise (the same
  products summed in the same order), new state included;
* ``linear_scan`` (the RG-LRU's log-depth prefill) against the
  reference's ``jax.lax.associative_scan`` and against the plain loop
  over time, within 1e-6 at lengths that take both odd and even halves
  (measured: bitwise against JAX here);
* ``rglru_block``, ``mlstm_block`` and ``slstm_block`` in prefill and in
  a one-step decode from the prefill's state: outputs and the new state
  within rtol = atol = 1e-5 (float matmuls summed in another order).

The gates see pre-activations past 20, where ``F.softplus`` would switch
to ``x`` and ``jax.nn.softplus`` (``logaddexp(x, 0)``) does not.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fake_quant as jfq
from repro.models import recurrent as jrec
from repro_torch.core.fake_quant import NullQATContext
from repro_torch.models import recurrent

TOL = 1e-5


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree))


def _params(spec_fn, args, seed, gate_bias=0.0):
    """Seeded weights of a JAX spec tree (fan-in scaled normals, biases
    ``gate_bias``)."""
    from repro.models.common import P
    rng = np.random.default_rng(seed)
    spec = spec_fn(*args)

    def make(p):
        if p.init == "zeros":
            return np.full(p.shape, gate_bias, np.float32)
        fan = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
        scale = p.scale if p.scale is not None else fan ** -0.5
        return (rng.normal(size=p.shape) * scale).astype(np.float32)
    return jax.tree_util.tree_map(make, spec,
                                  is_leaf=lambda x: isinstance(x, P))


def _close(got, want, tol=TOL):
    if want is None:          # conv state after a prefill of < W - 1 tokens
        assert got is None
        return
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _close(got[k], want[k], tol)
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("s", [1, 2, 3, 7])
def test_causal_conv1d_is_bitwise_jax(s):
    rng = np.random.default_rng(s)
    c = 24
    p = {"w": rng.normal(size=(4, c)).astype(np.float32) * 0.5,
         "b": rng.normal(size=c).astype(np.float32)}
    x = rng.normal(size=(2, s, c)).astype(np.float32)
    state = rng.normal(size=(2, 3, c)).astype(np.float32)
    conv = jrec.causal_conv1d       # eager: one op at a time, no FMA
    for st in (None, state):
        want, wstate = conv(p, jnp.asarray(x),
                            None if st is None else jnp.asarray(st))
        got, gstate = recurrent.causal_conv1d(
            _torch(p), torch.from_numpy(x),
            None if st is None else torch.from_numpy(st))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert (gstate is None) == (wstate is None)
        if wstate is not None:
            np.testing.assert_array_equal(gstate.numpy(), np.asarray(wstate))


@pytest.mark.parametrize("n", [1, 2, 5, 8, 13, 64])
def test_linear_scan_matches_associative_scan_and_the_loop(n):
    rng = np.random.default_rng(n)
    a = rng.uniform(0.5, 1.0, size=(2, n, 6)).astype(np.float32)
    b = rng.normal(size=(2, n, 6)).astype(np.float32)

    def combine(lhs, rhs):
        return lhs[0] * rhs[0], rhs[0] * lhs[1] + rhs[1]
    _, want = jax.jit(lambda a, b: jax.lax.associative_scan(
        combine, (a, b), axis=1))(a, b)
    _, got = recurrent.linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    h, loop = torch.zeros(2, 6), []
    for t in range(n):
        h = torch.from_numpy(a[:, t]) * h + torch.from_numpy(b[:, t])
        loop.append(h)
    np.testing.assert_allclose(got.numpy(), torch.stack(loop, 1).numpy(),
                               rtol=1e-5, atol=1e-5)


def _prefill_and_step(jfn, tfn, jp, x, kw):
    """Prefill over all but the last token, then one decode step from its
    state: both packages' outputs and states."""
    ctx, tctx = jfq.NullQATContext(), NullQATContext()
    pre = jax.jit(lambda p, x: jfn(ctx, p, x, **kw))
    step = jax.jit(lambda p, x, st: jfn(ctx, p, x, state=st, **kw))
    jout, jstate = pre(jp, jnp.asarray(x[:, :-1]))
    jstep, jstate2 = step(jp, jnp.asarray(x[:, -1:]), jstate)
    tp = _torch(jp)
    tout, tstate = tfn(tctx, tp, torch.from_numpy(x[:, :-1]), **kw)
    tstep, tstate2 = tfn(tctx, tp, torch.from_numpy(x[:, -1:]), state=tstate,
                         **kw)
    return (tout, tstate, tstep, tstate2), (jout, jstate, jstep, jstate2)


@pytest.mark.parametrize("s", [2, 9])
def test_rglru_block_prefill_and_decode_match_jax(s):
    d = 32
    jp = _params(jrec.rglru_spec, (d,), seed=s)
    x = np.random.default_rng(s + 1).normal(size=(2, s + 1, d)).astype(
        np.float32)
    got, want = _prefill_and_step(jrec.rglru_block, recurrent.rglru_block,
                                  jp, x, {})
    for g, w in zip(got, want):
        _close(g, w)
    assert got[1]["h"].dtype == torch.float32


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_blocks_prefill_and_decode_match_jax(kind):
    d, h, hd = 32, 4, 8
    spec = jrec.mlstm_spec if kind == "mlstm" else jrec.slstm_spec
    jfn = jrec.mlstm_block if kind == "mlstm" else jrec.slstm_block
    tfn = recurrent.mlstm_block if kind == "mlstm" \
        else recurrent.slstm_block
    # forget-gate biases of 25: pre-activations past softplus' switch at 20
    jp = _params(spec, (d, h, hd), seed=3, gate_bias=25.0)
    x = np.random.default_rng(4).normal(size=(2, 7, d)).astype(np.float32)
    got, want = _prefill_and_step(jfn, tfn, jp, x,
                                  dict(n_heads=h, head_dim=hd))
    for g, w in zip(got, want):
        _close(g, w)
    assert {k: v.dtype for k, v in got[3].items()} == \
        {k: torch.float32 for k in want[3]}
