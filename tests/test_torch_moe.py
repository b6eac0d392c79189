"""Port parity: the MoE feed-forward (``repro_torch.models.moe``).

The same weights and inputs (numpy, from a seed) go through the JAX
package's ``moe_ffn`` and the port's on the CPU.  Held: the output and
the load-balance loss within rtol = atol = 1e-5 (float matmuls and the
softmax summed in another order), and the chosen experts equal, at
capacities that drop tokens and at one that drops none, over one group
and several.  Ties in the router's probabilities go to the lower expert
index in both (``jax.lax.top_k``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fake_quant as jfq
from repro.models import moe as jmoe
from repro_torch.core.fake_quant import NullQATContext
from repro_torch.models import moe

TOL = 1e-5


def _case(b, s, d, f, e, seed):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    p = {"router": {"w": rng.normal(size=(d, e)).astype(f32)},
         "wi": {"w": (rng.normal(size=(e, d, f)) / np.sqrt(d)).astype(f32)},
         "wg": {"w": (rng.normal(size=(e, d, f)) / np.sqrt(d)).astype(f32)},
         "wo": {"w": (rng.normal(size=(e, f, d)) / np.sqrt(f)).astype(f32)}}
    x = rng.normal(size=(b, s, d)).astype(f32)
    return p, x


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(tree)


@pytest.mark.parametrize("b,s,e,k,cf,group,act", [
    (2, 12, 4, 2, 1.25, 512, "silu"),      # one group of 24: drops
    (1, 32, 8, 2, 1.25, 8, "silu"),        # four groups of 8, capacity 2
    (2, 16, 4, 2, 4.0, 512, "silu"),       # capacity 32: no drop
    (1, 24, 4, 1, 1.0, 12, "gelu")])       # top-1, GeGLU experts
def test_moe_ffn_matches_jax(monkeypatch, b, s, e, k, cf, group, act):
    d, f = 32, 48
    p, x = _case(b, s, d, f, e, seed=b * s + e)
    kw = dict(n_experts=e, top_k=k, capacity_factor=cf, group_size=group,
              activation=act)
    want, jaux = jax.jit(lambda p, x: jmoe.moe_ffn(jfq.NullQATContext(), p,
                                                   x, **kw))(p, x)
    chosen = []
    real = moe.top_k_experts
    monkeypatch.setattr(moe, "top_k_experts",
                        lambda probs, kk: chosen.append(real(probs, kk))
                        or chosen[-1])
    got, aux = moe.moe_ffn(NullQATContext(), _torch(p), torch.from_numpy(x),
                           **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    assert aux.dtype == torch.float32 and aux.dim() == 0
    np.testing.assert_allclose(float(aux), float(jaux), rtol=TOL, atol=TOL)
    # the experts JAX chooses from the same router probabilities
    n = min(group, b * s)
    xg = jnp.asarray(x).reshape(-1, n, d)
    _, jidx = jax.jit(lambda xg, w: jax.lax.top_k(jax.nn.softmax(
        jnp.einsum("gsd,de->gse", xg, w), axis=-1), k))(xg, p["router"]["w"])
    np.testing.assert_array_equal(chosen[0][1].numpy(), np.asarray(jidx))
    if cf < 4.0:        # at least one token dropped: rows differ from cf 4
        full, _ = moe.moe_ffn(NullQATContext(), _torch(p),
                              torch.from_numpy(x),
                              **{**kw, "capacity_factor": 8.0})
        assert not torch.allclose(full, got)


def test_top_k_ties_go_to_the_lower_index():
    probs = np.array([[0.2, 0.3, 0.3, 0.2], [0.25] * 4, [0.1, 0.4, 0.1, 0.4],
                      [0.5, 0.0, 0.5, 0.0]], np.float32)
    vals, idx = moe.top_k_experts(torch.from_numpy(probs), 2)
    jvals, jidx = jax.lax.top_k(jnp.asarray(probs), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    assert idx.tolist() == [[1, 2], [0, 1], [1, 3], [0, 2]]


def test_moe_ffn_refuses_a_partial_group():
    p, x = _case(1, 12, 8, 8, 4, seed=0)
    with pytest.raises(ValueError, match="whole number of groups"):
        moe.moe_ffn(NullQATContext(), _torch(p), torch.from_numpy(x),
                    n_experts=4, top_k=2, group_size=8)
