"""On the card: each CUDA kernel equals its plain PyTorch version, bitwise.

The kernels have no CPU mode, so every test here takes the ``cuda``
fixture, which skips on a machine without a card.  The file imports no
JAX, so it runs on the GPU machine as it is:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import affine
from repro_torch.kernels import fused_qmlp, int8_matmul
from repro_torch.rl import actorq, networks


@pytest.fixture
def cuda():
    """The card, or a skip: the CUDA kernels have no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only "
                    "there")
    return torch.device("cuda")


def _gemm_inputs(m, k, n, bits, seed):
    rng = np.random.default_rng(seed)
    x_q = rng.integers(-128, 128, size=(m, k)).astype(np.int8)
    half = 2 ** (bits - 1)
    w = torch.from_numpy(
        rng.integers(-half, half, size=(k, n)).astype(np.int8))
    w_q = affine.pack_int4(w) if bits <= 4 else w
    return (torch.from_numpy(x_q), w_q,
            torch.tensor(rng.uniform(0.01, 0.1), dtype=torch.float32),
            torch.tensor(float(rng.integers(-128, 128))),
            torch.from_numpy(rng.uniform(0.001, 0.05, size=n)
                             .astype(np.float32)),
            torch.from_numpy(rng.integers(-half, half, size=n)
                             .astype(np.float32)))


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("mkn", [(512, 9, 256), (512, 256, 256),
                                 (512, 256, 25), (37, 9, 256),
                                 (64, 4096, 512)])
def test_int8_matmul_kernel_equals_plain_on_card(cuda, bits, mkn):
    m, k, n = mkn
    args = [a.to(cuda) for a in _gemm_inputs(m, k, n, bits, seed=m + k + n)]
    before = int8_matmul.launches.value
    got = int8_matmul.int8_matmul_cuda(*args, w_bits=bits)
    want = int8_matmul.int8_matmul_plain(*args, w_bits=bits)
    torch.cuda.synchronize()
    assert int8_matmul.launches.value == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("widths", [(256, 256, 256), (4096, 512, 1024)])
@pytest.mark.parametrize("m", [8, 37, 512])
def test_fused_qmlp_kernel_equals_plain_on_card(cuda, bits, widths, m):
    gen = torch.Generator().manual_seed(m)
    params = networks.init_mlp(networks.mlp_spec(9, widths, 25), gen, cuda)
    calib = (torch.randn(64, 9, generator=gen) * 0.5).to(cuda)
    cache = actorq.calibrate_actor_cache(
        actorq.pack_actor_params(params, bits), calib)
    layers = actorq._fused_layers(cache, len(widths))
    obs = (torch.randn(m, 9, generator=gen) * 0.5).to(cuda)
    x_q = affine.quantize_with_params(
        obs, affine.AffineParams(layers[0].x_delta, layers[0].x_zero, 8))
    got = fused_qmlp.fused_qmlp_cuda(x_q, layers)
    want = fused_qmlp.fused_qmlp_plain(x_q, layers)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
