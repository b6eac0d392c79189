"""Port parity: the KV-cache quantizer and the int8 decode-attention op.

* ``core.affine.quantize_symmetric`` equals the JAX quantizer bitwise,
  ties (exact .5 quotients, rounded half to even) and all-zero rows
  included: every op is a correctly rounded float32 op in both packages.
* ``ops.int8_cache_attention`` on CPU tensors (the plain version, a dense
  softmax) agrees with the JAX op's ``ref`` oracle and its Pallas kernel
  in interpret mode within rtol = atol = 1e-5, the reference's attention
  contract (``docs/contracts.md``, "Attention parity"): it is float
  attention, so the summation order may differ.  Cases cover scalar and
  ragged ``pos``, window None and int, G > 1, T not a multiple of 32 and
  0-2 leading dims.
* The CUDA kernel itself is held against the plain version on the card in
  ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import affine as jaffine
from repro.kernels import ops as jops
from repro_torch.core import affine
from repro_torch.kernels import int8_cache_attention as ca
from repro_torch.kernels import ops


def _symmetric_inputs(seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(6, 3, 16)) * 5.0).astype(np.float32)
    x[0, 1] = 0.0                               # all-zero row: scale 1
    # amax 127 gives scale 1, so these quotients are exact halves
    x[1, 0, :8] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 126.5, -126.5]
    x[1, 0, 8:] = 0.25
    x[2, 2, :] = -3.0                           # every code -127
    return x


@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_symmetric_bitwise_vs_jax(seed):
    x = _symmetric_inputs(seed)
    want_c, want_s = jaffine.quantize_symmetric(jnp.asarray(x))
    got_c, got_s = affine.quantize_symmetric(torch.from_numpy(x))
    assert got_c.dtype == torch.int8 and got_s.dtype == torch.float32
    assert tuple(got_s.shape) == (6, 3, 1)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert got_c[1, 0, :8].tolist() == [127, 0, 2, 2, 0, -2, 126, -126]
    assert not bool(got_c[0, 1].any()) and float(got_s[0, 1, 0]) == 1.0


def _attention_inputs(lead, g, t, dh, seed):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return (rng.normal(size=lead + (g, dh)).astype(f32),
            rng.integers(-127, 128, size=lead + (t, dh)).astype(np.int8),
            rng.uniform(0.01, 0.1, size=lead + (t, 1)).astype(f32),
            rng.integers(-127, 128, size=lead + (t, dh)).astype(np.int8),
            rng.uniform(0.01, 0.1, size=lead + (t, 1)).astype(f32))


# (leading dims, G, T, Dh, pos, window)
CASES = [
    ((), 1, 37, 16, 20, None),
    ((), 3, 37, 16, 36, 5),
    ((3,), 2, 37, 16, [0, 17, 36], 8),
    ((2, 3), 4, 40, 32, [5, 39], None),
    ((2, 3), 1, 21, 8, [[0, 3, 20], [7, 11, 14]], 6),
    ((4,), 1, 8, 16, 7, 6),
]


@pytest.mark.parametrize("backend", ["ref", "interpret"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"lead{c[0]}-G{c[1]}"
                         f"-T{c[2]}-Dh{c[3]}-w{c[5]}")
def test_int8_cache_attention_plain_vs_jax(case, backend):
    lead, g, t, dh, pos, window = case
    args = _attention_inputs(lead, g, t, dh, seed=t * 7 + g)
    pos = np.asarray(pos, np.int32)
    want = np.asarray(jops.int8_cache_attention(
        *map(jnp.asarray, args), jnp.asarray(pos), window=window,
        backend=backend))
    got = ops.int8_cache_attention(*map(torch.from_numpy, args),
                                   torch.from_numpy(pos), window=window)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_int8_cache_attention_pos_rules():
    args = [torch.from_numpy(a)
            for a in _attention_inputs((3,), 2, 12, 8, seed=1)]
    with pytest.raises(ValueError, match="pos rank"):
        ops.int8_cache_attention(*args, torch.zeros((3, 2), dtype=torch.int32))
    with pytest.raises(ValueError, match="prefix"):
        ops.int8_cache_attention(*args, torch.zeros(4, dtype=torch.int32))
    # a python int is one shared position: it equals the ragged call
    shared = ops.int8_cache_attention(*args, 9, window=4)
    ragged = ops.int8_cache_attention(*args, torch.full((3,), 9), window=4)
    assert torch.equal(shared, ragged)


def test_window_masks_old_slots():
    """Only slots (pos - window, pos] count: rewriting older (and newer)
    slots leaves the output as it was."""
    q, kc, ks, vc, vs = map(torch.from_numpy,
                            _attention_inputs((), 2, 16, 8, seed=3))
    base = ops.int8_cache_attention(q, kc, ks, vc, vs, 10, window=4)
    kc2, vs2 = kc.clone(), vs.clone()
    kc2[:7] = 127
    vs2[11:] = 9.9
    got = ops.int8_cache_attention(q, kc2, ks, vc, vs2, 10, window=4)
    assert torch.equal(base, got)


def test_cuda_wrapper_rejects_cpu_tensors_and_counts_nothing():
    args = _attention_inputs((2,), 1, 8, 8, seed=5)
    before = ca.launches.value
    with pytest.raises(ValueError, match="CUDA"):
        ca.int8_cache_attention_cuda(*map(torch.from_numpy, args),
                                     torch.zeros(2, dtype=torch.int32))
    assert ca.launches.value == before
