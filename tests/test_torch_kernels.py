"""Port parity: the quantized ops (``repro_torch.kernels.ops``) vs JAX.

* ``ops.int8_matmul`` on CPU tensors (the plain version) equals the JAX
  ``ref`` oracle bitwise over bits {4, 8} x K {1, 9, 33, 256}: only
  products follow the int32 accumulate, so no float add can round
  differently.
* ``ops.fused_qmlp`` equals the JAX Pallas kernel in interpret mode within
  rtol = atol = 1e-5, the JAX package's own interpret-vs-ref tolerance
  (XLA may contract the epilogue's ``+ bias`` into an FMA under jit).
* The CUDA kernels themselves are held against the plain versions on the
  card in ``tests/test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import affine as jaffine
from repro.kernels import ops as jops
from repro.rl import actorq as jactorq
from repro.rl.networks import make_network
from repro_torch.core import affine
from repro_torch.kernels import build, fused_qmlp, int8_matmul, ops
from repro_torch.rl import actorq, networks


def _gemm_inputs(m, k, n, bits, seed):
    rng = np.random.default_rng(seed)
    x_q = rng.integers(-128, 128, size=(m, k)).astype(np.int8)
    half = 2 ** (bits - 1)
    w = rng.integers(-half, half, size=(k, n)).astype(np.int8)
    w_q = np.asarray(jaffine.pack_int4(jnp.asarray(w))) if bits <= 4 else w
    x_scale = np.float32(rng.uniform(0.01, 0.1))
    x_zero = np.float32(rng.integers(-128, 128))
    w_scale = rng.uniform(0.001, 0.05, size=n).astype(np.float32)
    w_zero = rng.integers(-half, half, size=n).astype(np.float32)
    return x_q, w_q, x_scale, x_zero, w_scale, w_zero


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("k", [1, 9, 33, 256])
def test_int8_matmul_bitwise_vs_jax_ref(bits, k):
    args = _gemm_inputs(17, k, 24, bits, seed=k * 10 + bits)
    want = jops.int8_matmul(*map(jnp.asarray, args), backend="ref",
                            w_bits=bits)
    got = ops.int8_matmul(*map(torch.tensor, args), w_bits=bits)
    assert got.dtype == torch.float32 and tuple(got.shape) == (17, 24)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_int8_matmul_rejects_k_mismatch():
    x_q, w_q, xs, xz, ws, wz = map(torch.tensor,
                                   _gemm_inputs(4, 9, 8, 4, seed=0))
    with pytest.raises(ValueError, match="byte-packed int4"):
        ops.int8_matmul(x_q, w_q, xs, xz, ws, wz, w_bits=8)   # packed as 8
    w_full = affine.unpack_int4(w_q, 9)
    with pytest.raises(ValueError, match="expects byte-packed"):
        ops.int8_matmul(x_q, w_full, xs, xz, ws, wz, w_bits=4)


def _calibrated(k, depth, bits, seed):
    """One MLP packed + calibrated by both packages on the same obs."""
    net = make_network((k,), 5, hidden=(24,) * depth)
    jparams = net.init(jax.random.PRNGKey(seed))
    obs = (np.random.default_rng(seed).normal(size=(11, k)) * 2.0
           ).astype(np.float32)
    jcache = jactorq.calibrate_actor_cache(
        jactorq.pack_actor_params(jparams, bits), jnp.asarray(obs),
        backend="ref")
    tparams = networks.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    tcache = actorq.calibrate_actor_cache(
        actorq.pack_actor_params(tparams, bits), torch.from_numpy(obs))
    return jcache, tcache, obs


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("k", [1, 9, 33, 256])
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_fused_qmlp_matches_jax_interpret(bits, k, depth):
    jcache, tcache, obs = _calibrated(k, depth, bits, seed=k + depth)
    want = jops.fused_qmlp(jnp.asarray(obs),
                           jactorq._fused_layers(jcache, depth),
                           backend="interpret")
    got = ops.fused_qmlp(torch.from_numpy(obs),
                         actorq._fused_layers(tcache, depth))
    assert tuple(got.shape) == (11, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_fused_qmlp_rejects_k_mismatch():
    _, tcache, obs = _calibrated(9, 2, 8, seed=3)
    layers = actorq._fused_layers(tcache, 2)
    with pytest.raises(ValueError, match="layer 0 expects K=9"):
        ops.fused_qmlp(torch.zeros(4, 8), layers)
    with pytest.raises(ValueError, match="at least one layer"):
        ops.fused_qmlp(torch.from_numpy(obs), ())


def test_kernel_wrappers_refuse_cpu_tensors_and_other_devices():
    x_q, w_q, xs, xz, ws, wz = map(torch.tensor,
                                   _gemm_inputs(4, 9, 8, 8, seed=1))
    with pytest.raises(ValueError, match="CUDA"):
        int8_matmul.int8_matmul_cuda(x_q, w_q, xs, xz, ws, wz)
    with pytest.raises(ValueError, match="CUDA"):
        fused_qmlp.fused_qmlp_cuda(x_q, ())
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.int8_matmul(x_q.to("meta"), w_q.to("meta"), xs, xz, ws, wz)


def test_launch_counter_counts_and_resets():
    c = build.LaunchCounter("k")
    for _ in range(3):
        c.add()
    assert c.value == 3
    c.reset()
    assert c.value == 0


def test_build_names_every_source_and_hashes_flags():
    assert set(build.SOURCES) == {"int8_matmul", "fused_qmlp",
                                  "int8_cache_attention", "fake_quant",
                                  "flash_attention"}
    assert sorted(build.SOURCES.values()) == sorted(
        p.name for p in build.CSRC.glob("*.cu"))
    for name, src in build.SOURCES.items():
        assert (build.CSRC / src).is_file()
        assert build._lib_path(name).name.startswith(f"lib{name}-")
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert "-fmad=false" in build.NVCC_FLAGS
