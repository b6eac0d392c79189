"""On the card: each CUDA kernel against its plain PyTorch version.

The integer GEMMs (B1, B2) and the fake quantizer (B5) are bitwise equal
to theirs; the int8-cache decode attention (B3) is float attention summed
in another order, so it agrees within rtol = atol = 1e-5, the
reference's attention contract.  A short QAT training run shows the
learner's path through B5.

The kernels have no CPU mode, so every test here takes the ``cuda``
fixture, which skips on a machine without a card.  The file imports no
JAX, so it runs on the GPU machine as it is:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import affine
from repro_torch.core.qconfig import QuantConfig
from repro_torch.kernels import (fake_quant, fused_qmlp, int8_cache_attention,
                                 int8_matmul, ops)
from repro_torch.rl import actorq, dqn, loops, networks
from repro_torch.rl import env as env_mod
from repro_torch.rl.env import batched_env
from repro_torch.rl.envs import make


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


def _attention_inputs(r, g, t, dh, seed):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    k = rng.normal(size=(r, t, dh)).astype(f32) * 3.0
    v = rng.normal(size=(r, t, dh)).astype(f32)
    kc, ks = affine.quantize_symmetric(torch.from_numpy(k))
    vc, vs = affine.quantize_symmetric(torch.from_numpy(v))
    return (torch.from_numpy(rng.normal(size=(r, g, dh)).astype(f32)),
            kc, ks, vc, vs)


@pytest.mark.parametrize("shape", [
    # (R, G, T, Dh, window): airnav_seq, catch_seq, odd sizes, long cache
    (512, 1, 121, 32, 8), (512, 1, 8, 32, 6), (7, 3, 37, 16, None),
    (5, 2, 50, 200, 9), (3, 1, 64, 256, None), (8, 4, 4096, 128, None)])
@pytest.mark.parametrize("ragged", [True, False])
def test_int8_cache_attention_kernel_vs_plain_on_card(cuda, shape, ragged):
    r, g, t, dh, window = shape
    args = [a.to(cuda) for a in _attention_inputs(r, g, t, dh, seed=r + t)]
    rng = np.random.default_rng(dh)
    pos = rng.integers(0, t, size=r) if ragged else np.full(r, t - 1)
    pos = torch.from_numpy(pos.astype(np.int32)).to(cuda)
    before = int8_cache_attention.launches.value
    got = int8_cache_attention.int8_cache_attention_cuda(*args, pos, window)
    want = int8_cache_attention.int8_cache_attention_plain(*args, pos,
                                                           window)
    torch.cuda.synchronize()
    assert int8_cache_attention.launches.value == before + 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_int8_cache_attention_op_on_card_and_leading_dims(cuda):
    q, kc, ks, vc, vs = _attention_inputs(6, 2, 20, 16, seed=1)
    lead = (2, 3)
    args = [a.reshape(lead + a.shape[1:]) for a in (q, kc, ks, vc, vs)]
    pos = torch.tensor([4, 19], dtype=torch.int32)
    want = ops.int8_cache_attention(*args, pos, window=5)      # CPU: plain
    before = int8_cache_attention.launches.value
    got = ops.int8_cache_attention(*[a.to(cuda) for a in args],
                                   pos.to(cuda), window=5)
    assert int8_cache_attention.launches.value == before + 1
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="Dh"):
        int8_cache_attention.int8_cache_attention_cuda(
            *[a.to(cuda) for a in _attention_inputs(1, 1, 4, 300, 0)],
            torch.zeros(1, dtype=torch.int32, device=cuda))


def test_cache_codes_on_card_equal_cpu(cuda):
    """The KV-cache writer: the same K gives the same codes and scales on
    the card as on the CPU (correctly rounded division, round half to
    even on both)."""
    rng = np.random.default_rng(0)
    k = torch.from_numpy((rng.normal(size=(512, 4, 32)) * 4.0)
                         .astype(np.float32))
    k[0, 0] = 0.0
    k[1, 0, :3] = torch.tensor([127.0, 0.5, 1.5])
    want = affine.quantize_symmetric(k)
    got = affine.quantize_symmetric(k.to(cuda))
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


def test_seq_rollout_on_card_launches_b3(cuda):
    """A short int8 cached rollout on the card: B3 launches once per block
    per step, B1 once per dense layer."""
    env = make("catch_seq")
    net = networks.make_network(env.spec.obs_shape, env.spec.n_actions,
                                transformer={"d_model": 32, "n_layers": 2,
                                             "d_ff": 64}, device=cuda)
    params = net.init(torch.Generator().manual_seed(0))
    benv = actorq.maybe_attach_seq_state(batched_env(env, 64), net, "int8",
                                         64, device=cuda)
    pol = dqn.make_behaviour_policy(benv, net, dqn.DQNConfig(
        actor_backend="int8"))(params, {}, torch.tensor(0, device=cuda),
                               torch.tensor(0, device=cuda))
    gen = torch.Generator(device=cuda).manual_seed(0)
    state, obs = benv.reset(gen, cuda)
    b3, b1 = int8_cache_attention.launches.value, int8_matmul.launches.value
    state, obs, traj = env_mod.rollout(benv, pol, params, state, obs, gen, 5)
    torch.cuda.synchronize()
    assert int8_cache_attention.launches.value - b3 == 2 * 5
    assert int8_matmul.launches.value - b1 == 14 * 5
    assert traj.action.device.type == "cuda"
    assert bool(torch.isfinite(traj.logits_or_value).all())


def _fq_input(kind, shape, bits, seed):
    rng = np.random.default_rng(seed)
    if kind == "zeros":
        return np.zeros(shape, np.float32)
    if kind == "positive":
        return rng.uniform(0.5, 2.0, size=shape).astype(np.float32)
    if kind == "ties":  # x / delta = k + 0.5 over the range (-32, 32)
        k = rng.integers(-100, 100, size=shape).astype(np.float32)
        return ((k + np.float32(0.5)) * np.float32(64.0 / 2 ** bits))
    return (rng.normal(size=shape) * 1.7).astype(np.float32)


@pytest.mark.parametrize("bits", [2, 4, 8, 16])
@pytest.mark.parametrize("kind,shape", [
    ("normal", (4, 64)), ("normal", (64, 64)), ("normal", (64, 2)),
    ("normal", (8, 64)), ("normal", (512, 256)), ("normal", (4096, 512)),
    ("normal", (1,)), ("normal", (7, 13)), ("normal", (2 ** 20 + 3,)),
    ("zeros", (8, 64)), ("positive", (64, 2)), ("ties", (4, 64))])
def test_fake_quant_kernel_equals_plain_on_card(cuda, bits, kind, shape):
    x = torch.from_numpy(_fq_input(kind, shape, bits, sum(shape) + bits)
                         ).to(cuda)
    if kind == "ties":
        lo, hi = torch.tensor(-32.0).to(cuda), torch.tensor(32.0).to(cuda)
    else:
        lo = torch.clamp(x.amin(), max=0.0) * 0.9
        hi = torch.clamp(x.amax(), min=0.0) * 0.8
    before = fake_quant.launches.value
    got = fake_quant.fake_quant_cuda(x, lo, hi, bits)
    want = fake_quant.fake_quant_plain(x, lo, hi, bits)
    torch.cuda.synchronize()
    assert fake_quant.launches.value == before + 1
    assert torch.equal(got, want)
    # the op: a view offset by one float takes the unaligned scalar loop
    if x.numel() > 1:
        xs = x.reshape(-1)[1:]
        assert torch.equal(ops.fake_quant_with_range(xs, lo, hi, bits),
                           fake_quant.fake_quant_plain(xs, lo, hi, bits))
    assert torch.equal(ops.fake_quant(x, bits).cpu(),
                       ops.fake_quant(x.cpu(), bits))


def test_qat_train_on_card_launches_b5(cuda):
    """Two QAT iterations on the card: 6 B5 launches per behaviour step,
    12 per TD update and 6 per eval step."""
    before = fake_quant.launches.value
    res = loops.train("dqn", "cartpole", iterations=2, record_every=2,
                      eval_episodes=4, quant=QuantConfig.qat(8, quant_delay=8))
    torch.cuda.synchronize()
    cfg = res.algo_cfg
    want = 6 * (2 * cfg.rollout_steps + res.eval_steps) \
        + 12 * 2 * cfg.updates_per_iter
    assert fake_quant.launches.value - before == want
    assert res.device.type == "cuda" and all(np.isfinite(res.rewards))
    assert all(bool(o.initialized) for o in res.state.observers.values())
