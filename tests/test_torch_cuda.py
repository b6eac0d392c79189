"""On the card: each CUDA kernel against its plain PyTorch version.

The integer GEMMs (B1, B2), the fake quantizer (B5) and its QAT site
kernel are bitwise equal to theirs; the int8-cache decode attention (B3) and the flash attention
(B4) are float attention summed in another order, so they agree within
rtol = atol = 1e-5, the reference's attention contract.  A short QAT
training run shows the learner's path through B5, a reduced-danube
prefill the LM's through B4, and a reduced serve run decode through B3
and PTQ through B5; the conv cases (``-k conv``) hold B1 at the conv
actor's im2col shapes and the Catch conv actor, its QAT training and
its anchors on the card.

The kernels have no CPU mode, so every test here takes the ``cuda``
fixture, which skips on a machine without a card.  The file imports no
JAX, so it runs on the GPU machine as it is:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import base as cfgs
from repro_torch.core import affine, ptq
from repro_torch.core.qconfig import QuantConfig
from repro_torch.kernels import (fake_quant, flash_attention, fused_qmlp,
                                 int8_cache_attention, int8_matmul, ops)
from repro_torch.launch import serve
from repro_torch.models import transformer
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


# the wgmma kernel's edges: one row and two row tiles, K below, at and past
# a 32-deep slice and long enough for a cluster's K split, N below one
# 8-wide tile and ragged; then the sequence actor's projections
B1_EDGE_ROWS = [(m, k, n) for m in (1, 8, 64, 65) for k in (4, 31, 32, 33, 4096)
                for n in (2, 8, 25)] + [(512, 32, 32), (512, 32, 64),
                                        (512, 32, 96), (512, 64, 32)]


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("mkn", [(512, 9, 256), (512, 256, 256),
                                 (512, 256, 25), (37, 9, 256),
                                 (64, 4096, 512)] + B1_EDGE_ROWS)
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


def _fused_case(cuda, k0, widths, n_out, bits, m, seed):
    """A calibrated MLP k0 -> widths -> n_out and m observations on the
    card: (input codes, kernel layers)."""
    gen = torch.Generator().manual_seed(seed)
    params = networks.init_mlp(networks.mlp_spec(k0, widths, n_out), gen,
                               cuda)
    calib = (torch.randn(32, k0, generator=gen) * 0.5).to(cuda)
    cache = actorq.calibrate_actor_cache(
        actorq.pack_actor_params(params, bits), calib)
    layers = actorq._fused_layers(cache, len(widths))
    obs = (torch.randn(m, k0, generator=gen) * 0.5).to(cuda)
    x_q = affine.quantize_with_params(
        obs, affine.AffineParams(layers[0].x_delta, layers[0].x_zero, 8))
    return x_q, layers


def _fused_one_launch(x_q, layers):
    before = fused_qmlp.launches.value
    got = fused_qmlp.fused_qmlp_cuda(x_q, layers)
    want = fused_qmlp.fused_qmlp_plain(x_q, layers)
    torch.cuda.synchronize()
    assert fused_qmlp.launches.value == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("m", [1, 8, 37, 64])
def test_fused_qmlp_kernel_cartpole_net_on_card(cuda, bits, m):
    """The int4 / int8 training run's net, 4-64-64-2, at behaviour and
    evaluation batch sizes: bitwise, one launch."""
    _fused_one_launch(*_fused_case(cuda, 4, (64, 64), 2, bits, m, seed=m))


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("k0", [4, 9, 33])
@pytest.mark.parametrize("n", [1, 2, 7, 9])
@pytest.mark.parametrize("m", [15, 16, 17])
def test_fused_qmlp_kernel_tile_edges_on_card(cuda, bits, k0, n, m):
    """The edges of the tiling: widths below, at and past one n8 tile
    (split K over the warps), K below, at and past a 32-deep step, rows
    around one 16-row block."""
    _fused_one_launch(*_fused_case(cuda, k0, (n, n), n, bits, m,
                                   seed=k0 * 100 + n * 10 + m))


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


def _b3_inputs(cuda, nb, nh, g, t, dh, pos, *, lm, seed):
    """B3 inputs on the card: q (NB, NH, G, Dh), the cache as (NB, NH, T,
    Dh) -- a transposed view of a (NB, T, NH, Dh) cache with ``lm`` --
    and ``pos`` (NB, NH) int32."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    shape = (nb, t, nh, dh) if lm else (nb, nh, t, dh)
    k = torch.from_numpy(rng.normal(size=shape).astype(f32) * 3.0).to(cuda)
    v = torch.from_numpy(rng.normal(size=shape).astype(f32)).to(cuda)
    kc, ks = affine.quantize_symmetric(k)
    vc, vs = affine.quantize_symmetric(v)
    if lm:
        kc, ks, vc, vs = (x.transpose(1, 2) for x in (kc, ks, vc, vs))
    q = torch.from_numpy(rng.normal(size=(nb, nh, g, dh)).astype(f32))
    pos = torch.as_tensor(np.broadcast_to(np.asarray(pos, np.int32),
                                          (nb, nh)).copy())
    return q.to(cuda), kc, ks, vc, vs, pos.to(cuda)


def _b3_one_launch(args, window):
    """One launch a call, within 1e-5 of the plain version, and a second
    call bitwise equal to the first (scratch and arrival counters left
    clean by the merge)."""
    before = int8_cache_attention.launches.value
    got = int8_cache_attention.int8_cache_attention_cuda(*args, window)
    again = int8_cache_attention.int8_cache_attention_cuda(*args, window)
    want = int8_cache_attention.int8_cache_attention_plain(*args, window)
    torch.cuda.synchronize()
    assert int8_cache_attention.launches.value == before + 2
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, again)
    return got


@pytest.mark.parametrize("g", [1, 4, 8])
@pytest.mark.parametrize("dh", [32, 80, 128, 256])
@pytest.mark.parametrize("t", [1, 63, 64, 65, 4096])
def test_int8_cache_attention_edges_on_card(cuda, t, dh, g):
    """Slot counts around one 64-slot tile and a long cache (split 32
    ways over 3 problems), ragged pos from the first slot to the last."""
    pos = [[t - 1, t // 2, 0]]
    _b3_one_launch(_b3_inputs(cuda, 1, 3, g, t, dh, pos, lm=False,
                              seed=t + dh + g), None)


@pytest.mark.parametrize("window,pos", [(100, 4095), (1000, 2000),
                                        (3000, 3500), (200, 150),
                                        (4096, 4095), (5000, 1234)])
def test_int8_cache_attention_windows_across_splits_on_card(cuda, window,
                                                            pos):
    """Windows that start and end inside a split, and windows at or past
    the cache; the second problem's pos is ragged."""
    assert int8_cache_attention.plan(2, 4, 4096, 80, window)["splits"] > 1 \
        or window < 256
    _b3_one_launch(_b3_inputs(cuda, 1, 2, 4, 4096, 80, [[pos, pos // 3]],
                              lm=False, seed=window), window)


@pytest.mark.parametrize("t,pos", [(64, "ragged"), (4096, 4095),
                                   (4096, "ragged"), (300, 299)])
def test_int8_cache_attention_lm_views_on_card(cuda, t, pos):
    """Danube's decode layout, 4 x 8 KV heads of G 4 and Dh 80 read in
    place from a (B, T, KV, Dh) cache, directly and through the op."""
    if pos == "ragged":
        pos = np.random.default_rng(t).integers(0, t, size=(4, 8))
    args = _b3_inputs(cuda, 4, 8, 4, t, 80, pos, lm=True, seed=t)
    assert args[1].stride() == (t * 8 * 80, 80, 8 * 80, 1)
    got = _b3_one_launch(args, None)
    before = int8_cache_attention.launches.value
    via_op = ops.int8_cache_attention(*args)
    assert int8_cache_attention.launches.value == before + 1
    assert torch.equal(via_op, got)


@pytest.mark.parametrize("g,dh", [(3, 6), (2, 20), (16, 200), (5, 8)])
@pytest.mark.parametrize("t", [40, 1500])
def test_int8_cache_attention_odd_shapes_on_card(cuda, g, dh, t):
    """Head dims that take 1-, 4- and 8-byte copies, odd and large G."""
    pos = [[t - 1, t // 3]]
    _b3_one_launch(_b3_inputs(cuda, 1, 2, g, t, dh, pos, lm=False,
                              seed=g * dh + t), 700 if t > 1000 else None)


@pytest.mark.parametrize("t", [64, 4096])
def test_int8_cache_attention_empty_rows_write_zero_on_card(cuda, t):
    """A problem with pos < 0 has no valid slot and writes 0, split or
    not; the others are untouched by it."""
    args = _b3_inputs(cuda, 1, 2, 4, t, 32, [[-1, t - 1]], lm=False, seed=t)
    before = int8_cache_attention.launches.value
    got = int8_cache_attention.int8_cache_attention_cuda(*args)
    again = int8_cache_attention.int8_cache_attention_cuda(*args)
    want = int8_cache_attention.int8_cache_attention_plain(*args)
    torch.cuda.synchronize()
    assert int8_cache_attention.launches.value == before + 2
    assert not bool(got[0, 0].any()) and torch.equal(got, again)
    torch.testing.assert_close(got[0, 1], want[0, 1], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("g,dh", [(1, 32), (4, 80), (4, 128), (8, 256),
                                  (16, 256), (3, 6), (16, 32)])
@pytest.mark.parametrize("r,t", [(1, 64), (8, 4096), (512, 121),
                                 (1, 65536)])
def test_int8_cache_attention_plan_matches_the_kernel(cuda, g, dh, r, t):
    """``plan``'s shared-memory bytes are the built kernel's."""
    p = int8_cache_attention.plan(r, g, t, dh)
    assert int8_cache_attention.kernel_smem(g, dh, p["per"],
                                            p["splits"]) == p["smem"]


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


SITE_DELAY = 6
SITE_STEPS = {"before": SITE_DELAY - 1, "at": SITE_DELAY,
              "after": SITE_DELAY + 3}


def _site_state(initialized, dev):
    if initialized:
        return (torch.tensor(-1.25, device=dev), torch.tensor(2.5, device=dev),
                torch.tensor(True, device=dev))
    return (torch.zeros((), device=dev), torch.zeros((), device=dev),
            torch.zeros((), dtype=torch.bool, device=dev))


def _same(got, want):
    """Equal values, NaN where NaN (-0.0 equals 0.0)."""
    got, want = got.cpu(), want.cpu()
    nan = torch.isnan(want)
    return bool(torch.equal(torch.isnan(got), nan)
                and torch.equal(got[~nan], want[~nan]))


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("kind,shape", [
    # the CartPole sites (weights, TD batch 64, rollout batch 8), then the
    # sizes past one block (a range pass and a quantize pass)
    ("normal", (4, 64)), ("normal", (64, 64)), ("normal", (64, 2)),
    ("normal", (8, 64)), ("zeros", (8, 64)), ("positive", (64, 2)),
    ("ties", (4, 64)), ("nan", (64, 64)), ("normal", (512, 256)),
    ("normal", (4096, 512)), ("normal", (2 ** 20 + 3,))])
@pytest.mark.parametrize("initialized", [False, True],
                         ids=["fresh", "initialized"])
@pytest.mark.parametrize("when", list(SITE_STEPS))
def test_site_kernel_equals_plain_on_card(cuda, when, initialized, kind,
                                          shape, bits):
    """One launch per site up to 4,096 elements and two above (a range
    pass and a quantize pass), output and new state bitwise (NaN for
    NaN)."""
    step = torch.tensor(SITE_STEPS[when], dtype=torch.int32, device=cuda)
    if kind == "nan":
        x_np = _fq_input("normal", shape, bits, sum(shape))
        x_np.flat[len(shape) * 17] = np.nan
    else:
        x_np = _fq_input(kind, shape, bits, sum(shape) + bits)
    x = torch.from_numpy(x_np).to(cuda)
    state = _site_state(initialized, cuda)
    per_site = 1 if x.numel() <= 4096 else 2
    before = fake_quant.launches.value
    got = fake_quant.activation_site_cuda(x, *state, step, SITE_DELAY,
                                          0.999, bits)
    assert fake_quant.launches.value == before + per_site
    want = fake_quant.activation_site_plain(x, *state, step, SITE_DELAY,
                                            0.999, bits)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert _same(g, w)
    assert _same(state[0], _site_state(initialized, cuda)[0])  # functional
    w_got = fake_quant.weight_site_cuda(x, step.to(torch.int64), SITE_DELAY,
                                        bits)
    assert fake_quant.launches.value == before + 2 * per_site
    assert _same(w_got, fake_quant.weight_site_plain(x, step, SITE_DELAY,
                                                     bits))


def test_site_ops_on_card_through_the_context(cuda):
    """The context's sites on the card: one launch each, equal to the CPU
    composition, and the state kept on the card."""
    from repro_torch.core import fake_quant as core_fq
    rng = np.random.default_rng(0)
    coll = {}
    cfg = QuantConfig.qat(8, quant_delay=2)
    for step in (0, 1, 2, 3):
        x = torch.from_numpy((rng.normal(size=(64, 64)) * (1 + step))
                             .astype(np.float32))
        ctx = core_fq.make_context(cfg, coll, torch.tensor(step, device=cuda))
        cpu = core_fq.make_context(
            cfg, {k: core_fq.ObserverState(*(t.cpu() for t in v))
                  for k, v in coll.items()}, torch.tensor(step))
        before = fake_quant.launches.value
        got = (ctx.activation("a/out", x.to(cuda)),
               ctx.weight("a/w", x.to(cuda)))
        assert fake_quant.launches.value == before + 2
        want = (cpu.activation("a/out", x), cpu.weight("a/w", x))
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
        coll = ctx.merged_collection()
        assert coll["a/out"].vmin.device.type == "cuda"
        for g, w in zip(coll["a/out"], cpu.merged_collection()["a/out"]):
            assert torch.equal(g.cpu(), w)


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


@pytest.mark.parametrize("shape", [
    # (B, H, KV, S, T, D, causal, window, softcap): the chip_smoke rows at
    # reduced sizes (danube prefill, gemma2 local and global, whisper's
    # encoder, end-aligned, ragged), fully masked rows, odd head dims
    (1, 8, 2, 512, 512, 80, True, 128, None),
    (1, 4, 2, 512, 512, 256, True, 128, 50.0),
    (1, 4, 2, 384, 384, 256, True, None, 50.0),
    (1, 6, 6, 300, 300, 64, False, None, None),
    (1, 8, 2, 8, 1024, 80, True, None, None),
    (2, 4, 4, 1000, 1000, 32, True, None, None),
    (1, 2, 1, 16, 8, 32, True, None, None),
    (1, 2, 1, 70, 90, 40, True, 20, None),
    (1, 2, 2, 65, 65, 200, False, 30, 30.0),
    (3, 3, 1, 1, 77, 16, True, 5, None)])
def test_flash_attention_kernel_vs_plain_on_card(cuda, shape):
    b, h, kv, s, t, d, causal, window, softcap = shape
    rng = np.random.default_rng(s + t + d)
    q, k, v = (torch.from_numpy(rng.normal(size=sh).astype(np.float32)
                                ).to(cuda)
               for sh in ((b, s, h, d), (b, t, kv, d), (b, t, kv, d)))
    kw = dict(causal=causal, window=window, softcap=softcap)
    before = flash_attention.launches.value
    got = flash_attention.flash_attention_cuda(q, k, v, **kw)
    want = flash_attention.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches.value == before + 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    if causal and s > t:                    # rows before every key: 0
        assert not got[:, :s - t].any()


@pytest.mark.parametrize("d", [40, 64, 80, 256])
@pytest.mark.parametrize("h,kv", [(8, 2), (2, 2)])
@pytest.mark.parametrize("s", [1, 8])
def test_flash_attention_key_split_on_card(cuda, s, h, kv, d):
    """Short query blocks against 4,096 keys: the key axis is split over a
    cluster (the plan says so), G = 4 query heads packed with their KV
    head or G = 1; within 1e-5 of the plain version, one launch."""
    t = 4096
    assert flash_attention.plan(1, s, t, h, kv, d)["cluster"] > 1
    rng = np.random.default_rng(s + h + d)
    q, k, v = (torch.from_numpy(rng.normal(size=sh).astype(np.float32)
                                ).to(cuda)
               for sh in ((1, s, h, d), (1, t, kv, d), (1, t, kv, d)))
    before = flash_attention.launches.value
    got = flash_attention.flash_attention_cuda(q, k, v)
    want = flash_attention.flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches.value == before + 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d", [16, 40, 64, 80, 200, 256])
def test_flash_attention_plan_matches_the_kernel(cuda, d):
    """``plan``'s shared memory and rows a block are the built kernel's."""
    got = flash_attention.kernel_shape(d)
    want = flash_attention.plan(1, 64, 64, 2, 1, d)
    assert got == dict(smem=want["smem"], bq=want["bq"])


def test_flash_attention_op_on_card_and_refusals(cuda):
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(2, 40, 4, 32)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(2, 40, 2, 32)).astype(np.float32))
    want = ops.flash_attention(q, k, k, window=9)             # CPU: plain
    before = flash_attention.launches.value
    got = ops.flash_attention(q.to(cuda).transpose(1, 2).contiguous()
                              .transpose(1, 2), k.to(cuda), k.to(cuda),
                              window=9)                  # a strided view
    assert flash_attention.launches.value == before + 1
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    big = torch.zeros(1, 4, 1, 300, device=cuda)
    with pytest.raises(ValueError, match="D <= 256"):
        flash_attention.flash_attention_cuda(big, big, big)
    half = torch.zeros(1, 4, 1, 32, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="float32"):
        flash_attention.flash_attention_cuda(half, half, half)
    x = torch.zeros(1, 4, 3, 32, device=cuda)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention.flash_attention_cuda(x, x[:, :, :2].contiguous(),
                                             x[:, :, :2].contiguous())
    assert flash_attention.launches.value == before + 1


def test_reduced_danube_prefill_on_card_launches_b4_per_layer(cuda):
    """A reduced-danube prefill of 300 tokens (ring window 32): one B4
    launch per layer, and the CPU path's logits within 1e-4 (cuBLAS and
    the CPU's BLAS sum in other orders)."""
    cfg = cfgs.get_reduced("h2o-danube-1.8b")
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     "cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 300),
                           generator=torch.Generator().manual_seed(1))
    want = transformer.prefill(cfg, params, tokens)
    before = flash_attention.launches.value
    got = transformer.prefill(cfg, ptq.tree_to(params, cuda), tokens.to(cuda))
    torch.cuda.synchronize()
    assert flash_attention.launches.value - before == cfg.n_layers
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


def test_reduced_serve_on_card_launches_b3_and_b5(cuda, capsys):
    """``launch.serve`` on the card with an int8 cache and PTQ int8
    weights: B3 once per layer and decode step, B5 once per weight leaf
    (11 for danube), and the tokens of the same run on the CPU."""
    argv = ["--arch", "h2o-danube-1.8b", "--reduced", "--batch", "2",
            "--prompt-len", "8", "--new-tokens", "4", "--int8-cache",
            "--quant", "ptq_int8"]
    b3, b5 = int8_cache_attention.launches.value, fake_quant.launches.value
    assert serve.main(argv) == 0
    card = capsys.readouterr().out
    assert int8_cache_attention.launches.value - b3 == 2 * 11
    assert fake_quant.launches.value - b5 == 11
    assert torch.cuda.get_device_name(0) in card
    assert serve.main(argv + ["--device", "cpu"]) == 0
    host = capsys.readouterr().out
    assert card.splitlines()[-1] == host.splitlines()[-1]


# --- the actor-learner and async topologies --------------------------------

# tests/test_actor_learner.py:31
SMALL_DQN = dict(n_envs=4, rollout_steps=4, updates_per_iter=2,
                 buffer_size=512, batch_size=16, warmup=8)


def _same_run(a, b) -> bool:
    return (a.rewards == b.rewards
            and int(a.state.extras.updates) == int(b.state.extras.updates)
            and all(torch.equal(x, y) for (_, x), (_, y) in zip(
                ptq.tree_tensors(a.state.params),
                ptq.tree_tensors(b.state.params))))


@pytest.mark.parametrize("backend", ["fp32", "int8"])
def test_topology_anchors_on_card(cuda, backend):
    """On the card, as on the CPU: actor-learner with one actor and a push
    every iteration is the fused driver bit for bit, and async in barrier
    mode the actor-learner run (one CUDA generator drawn in host order,
    the async chunks on two streams)."""
    kw = dict(iterations=6, record_every=3, eval_episodes=2, seed=7,
              actor_backend=backend, algo_overrides=dict(SMALL_DQN))
    fused = loops.train("dqn", "cartpole", **kw)
    sync = loops.train("dqn", "cartpole", topology="actor-learner",
                       num_actors=1, sync_every=1, **kw)
    barrier = loops.train("dqn", "cartpole", topology="async", num_actors=1,
                          sync_every=SMALL_DQN["updates_per_iter"],
                          async_barrier=True, steps_per_call=1, **kw)
    assert _same_run(fused, sync)
    assert _same_run(sync, barrier)


def _async_setup(cuda, backend, calib_batch=0, replay="uniform"):
    from repro_torch.rl import actor_learner
    env = make("cartpole")
    net = networks.make_network(env.spec.obs_shape, env.spec.n_actions,
                                device=cuda)
    cfg = dqn.DQNConfig(actor_backend=backend, calib_batch=calib_batch,
                        replay=replay)
    al = actor_learner.ActorLearnerConfig(num_actors=4, sync_every=16)
    progs = actor_learner.make_async_actor_learner("dqn", env, net, cfg, al,
                                                   device=cuda)
    learner, wbuf = actor_learner.init_async(
        torch.Generator().manual_seed(0), env, net, "dqn", cfg, al)
    env_state, obs = progs.benv_global.reset(
        torch.Generator(device=cuda).manual_seed(1), cuda)
    progs.streams.start()
    progs.streams.share((learner, wbuf, env_state, obs))
    snap = progs.make_snapshot(learner, obs)
    return progs, [learner, wbuf, env_state, obs, snap]


def _async_round(progs, carry, gen):
    """One round of the async driver with a push: actor chunk, learner
    chunk, slot swap, snapshot, divergence."""
    from repro_torch.rl import actor_learner
    learner, wbuf, env_state, obs, snap = carry
    env_state, obs, wbuf, _ = progs.actor_chunk(snap, env_state, obs, wbuf,
                                                gen, n_chunks=2)
    learner, _ = progs.learner_chunk(learner, gen, n_updates=16)
    learner, wbuf = actor_learner.swap_read_slot(learner, wbuf,
                                                 progs.streams)
    snap = progs.make_snapshot(learner, obs)
    div = progs.divergence(learner, snap, obs)
    carry[:] = [learner, wbuf, env_state, obs, snap]
    return div


@pytest.mark.parametrize("backend,calib,replay", [
    ("int8", 0, "uniform"), ("int4", 32, "uniform"),
    ("fp32", 0, "prioritized")])
def test_async_round_makes_no_host_sync_on_card(cuda, backend, calib,
                                                replay):
    """A whole async round (both chunks, the swap, the push and the
    divergence) runs under ``set_sync_debug_mode("error")``: nothing in
    it waits on the card from the host."""
    progs, carry = _async_setup(cuda, backend, calib, replay)
    gen = torch.Generator(device=cuda).manual_seed(2)
    _async_round(progs, carry, gen)              # warm: allocations, builds
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        div = _async_round(progs, carry, gen)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    progs.streams.finish()
    torch.cuda.synchronize()
    assert tuple(div.shape) == (4,) and bool(torch.isfinite(div).all())


def test_async_chunks_run_on_two_streams_on_card(cuda, monkeypatch):
    """The actor chunk's kernels go to the actors' stream, the learner
    chunk's and the divergence's to the learner's, and the two differ."""
    from repro_torch.rl import buffer as rb
    progs, carry = _async_setup(cuda, "int8")
    seen = {"b1": set(), "sample": set()}
    real_mm, real_sample = int8_matmul.int8_matmul_cuda, \
        rb.replay_sample_sharded

    def mm(*a, **k):
        seen["b1"].add(torch.cuda.current_stream().stream_id)
        return real_mm(*a, **k)

    def sample(*a, **k):
        seen["sample"].add(torch.cuda.current_stream().stream_id)
        return real_sample(*a, **k)
    monkeypatch.setattr(int8_matmul, "int8_matmul_cuda", mm)
    monkeypatch.setattr(rb, "replay_sample_sharded", sample)
    learner, wbuf, env_state, obs, snap = carry
    gen = torch.Generator(device=cuda).manual_seed(2)
    progs.actor_chunk(snap, env_state, obs, wbuf, gen, n_chunks=1)
    actor_b1 = set(seen["b1"])
    progs.learner_chunk(learner, gen, n_updates=2)
    progs.divergence(learner, snap, obs)
    torch.cuda.synchronize()
    a, lrn = progs.streams.actor.stream_id, progs.streams.learner.stream_id
    assert a != lrn
    assert actor_b1 == {a}
    assert seen["sample"] == {lrn}
    assert seen["b1"] == {a, lrn}


def test_topology_path_kernels_equal_plain_on_card(cuda, monkeypatch):
    """Every B1 and B2 launch of an async round (behaviour steps of 4
    actors x 8 envs, per-actor divergence heads of 8 rows, calibrations)
    equals its plain version on the same inputs, bit for bit, for int8,
    int4, and int4 calibrated actors."""
    shapes = set()
    real_mm, real_fq = int8_matmul.int8_matmul_cuda, \
        fused_qmlp.fused_qmlp_cuda

    def mm(x_q, w_q, *args, w_bits=8):
        out = real_mm(x_q, w_q, *args, w_bits=w_bits)
        want = int8_matmul.int8_matmul_plain(x_q, w_q, *args, w_bits=w_bits)
        assert torch.equal(out, want)
        shapes.add(("B1", x_q.shape[0], x_q.shape[1], w_q.shape[1], w_bits))
        return out

    def fq(x_q, layers):
        out = real_fq(x_q, layers)
        assert torch.equal(out, fused_qmlp.fused_qmlp_plain(x_q, layers))
        shapes.add(("B2", x_q.shape[0], layers[0].bits))
        return out
    monkeypatch.setattr(int8_matmul, "int8_matmul_cuda", mm)
    monkeypatch.setattr(fused_qmlp, "fused_qmlp_cuda", fq)
    for backend, calib in (("int8", 0), ("int4", 0), ("int4", 32)):
        progs, carry = _async_setup(cuda, backend, calib)
        _async_round(progs, carry, torch.Generator(device=cuda).manual_seed(3))
        torch.cuda.synchronize()
    for bits in (8, 4):
        for m in (32, 8):
            assert {("B1", m, 4, 64, bits), ("B1", m, 64, 64, bits),
                    ("B1", m, 64, 2, bits)} <= shapes
    assert {("B2", 32, 4), ("B2", 8, 4)} <= shapes


# --- the conv actor (the paper's Atari backbone on pixel Catch) ------------

# B1 at the conv path's shapes (im2col GEMMs of 8 Catch envs, M 800, and of
# a TD-sized batch; the fc and head at 8 rows), Catch's one-channel first
# layer at K 9 (int4: 5 packed rows), and the long K of Policy C's convs
# (9,216) and fc (102,400)
CONV_B1_ROWS = [(800, 9, 128), (800, 1152, 128), (8, 12800, 128),
                (8, 128, 3), (800, 9, 4), (1600, 72, 8), (16, 800, 32),
                (6400, 1152, 128), (800, 9216, 1024), (8, 102400, 2048)]


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("mkn", CONV_B1_ROWS)
def test_int8_matmul_conv_shapes_equal_plain_on_card(cuda, bits, mkn):
    m, k, n = mkn
    args = [a.to(cuda) for a in _gemm_inputs(m, k, n, bits, seed=m + k)]
    got = int8_matmul.int8_matmul_cuda(*args, w_bits=bits)
    want = int8_matmul.int8_matmul_plain(*args, w_bits=bits)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("k", [9, 102400])
def test_int8_matmul_extreme_codes_conv_k_on_card(cuda, bits, k):
    """Codes at the ends of their range and zero points that push the
    corrected int32 bracket past 2**31 at K 102,400: the kernel wraps as
    the plain version's int32 arithmetic does, bit for bit."""
    m, n = 8, 16
    lo, hi = (-8, 7) if bits <= 4 else (-128, 127)
    x_q = torch.full((m, k), -128, dtype=torch.int8)
    x_q[1::2] = 127
    w = torch.full((k, n), lo, dtype=torch.int8)
    w[:, 1::2] = hi
    w_q = affine.pack_int4(w) if bits <= 4 else w
    args = [t.to(cuda) for t in (
        x_q, w_q, torch.tensor(0.01), torch.tensor(127.0),
        torch.full((n,), 0.002), torch.full((n,), float(lo)))]
    got = int8_matmul.int8_matmul_cuda(*args, w_bits=bits)
    want = int8_matmul.int8_matmul_plain(*args, w_bits=bits)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _conv_net(cuda, filters, fc, seed=0):
    net = networks.make_network((10, 10, 1), 3, conv_filters=filters,
                                fc_width=fc, device=cuda)
    return net, net.init(torch.Generator(device=cuda).manual_seed(seed))


@pytest.mark.parametrize("filters,fc", [((4,), 16), ((128, 128, 128), 128)])
@pytest.mark.parametrize("bits", [4, 8])
def test_conv_actor_equals_its_plain_replay_on_card(cuda, monkeypatch,
                                                    filters, fc, bits):
    """The int8 / int4 conv actor on Catch boards: 5 B1 launches a forward
    at Policy A width (3 convs, fc, head), its output bitwise the same
    actor through B1's plain version, and within 1e-4 of the CPU's."""
    net, params = _conv_net(cuda, filters, fc)
    qp = actorq.pack_actor_params(params, bits)
    env = batched_env(make("catch"), 8)
    _, obs = env.reset(torch.Generator(device=cuda).manual_seed(1))
    before = int8_matmul.launches.value
    got = actorq.quantized_apply(qp, obs)
    torch.cuda.synchronize()
    assert int8_matmul.launches.value - before == len(filters) + 2
    monkeypatch.setattr(int8_matmul, "int8_matmul_cuda",
                        int8_matmul.int8_matmul_plain)
    assert torch.equal(got, actorq.quantized_apply(qp, obs))
    cpu = actorq.quantized_apply(ptq.tree_to(qp, "cpu"), obs.cpu())
    torch.testing.assert_close(got.cpu(), cpu, rtol=0, atol=1e-4)
    fp32 = net.apply(params, obs)
    torch.testing.assert_close(
        fp32.cpu(), net.apply(ptq.tree_to(params, "cpu"), obs.cpu()),
        rtol=0, atol=1e-4)


def _site_launches(n: int) -> int:
    return 1 if n <= 4096 else 2


def test_qat_conv_train_on_card_launches_b1_and_b5(cuda):
    """Two QAT iterations of DQN on Catch with int8 conv actors: B1 five
    times a behaviour and an eval step (3 convs, fc, head), B5 at every
    activation and dense-weight site of the learner's two forwards a TD
    update (conv sites are plain torch), each site one launch up to 4,096
    elements and two above."""
    filters, fc = (8, 8, 8), 32
    b1, b5 = int8_matmul.launches.value, fake_quant.launches.value
    res = loops.train("dqn", "catch", iterations=2, record_every=2,
                      eval_episodes=4, actor_backend="int8",
                      quant=QuantConfig.qat(8, quant_delay=8),
                      net_kwargs=dict(conv_filters=filters, fc_width=fc))
    torch.cuda.synchronize()
    cfg = res.algo_cfg
    steps = 2 * cfg.rollout_steps
    assert int8_matmul.launches.value - b1 == 5 * (steps + res.eval_steps)
    batch = cfg.batch_size
    per_forward = sum(_site_launches(batch * 100 * f) for f in filters) \
        + _site_launches(100 * filters[-1] * fc) + _site_launches(batch * fc) \
        + _site_launches(fc * 3) + _site_launches(batch * 3)
    assert fake_quant.launches.value - b5 == \
        2 * per_forward * 2 * cfg.updates_per_iter
    assert sorted(res.state.observers) == [
        "conv0/out", "conv1/out", "conv2/out", "fc/out", "out/out"]
    assert all(np.isfinite(res.rewards))


@pytest.mark.parametrize("backend", ["fp32", "int8"])
def test_conv_topology_anchors_on_card(cuda, backend):
    """The three anchors on the card with a small conv net on Catch, with
    cuDNN deterministic: actor-learner with one actor is the fused driver,
    async in barrier mode is actor-learner, and ``steps_per_call`` 3 is
    the per-step driver, bit for bit."""
    kw = dict(iterations=6, record_every=3, eval_episodes=2, seed=7,
              actor_backend=backend, algo_overrides=dict(SMALL_DQN),
              net_kwargs=dict(conv_filters=(8, 8), fc_width=32))
    fused = loops.train("dqn", "catch", **kw)
    sync = loops.train("dqn", "catch", topology="actor-learner",
                       num_actors=1, sync_every=1, **kw)
    barrier = loops.train("dqn", "catch", topology="async", num_actors=1,
                          sync_every=SMALL_DQN["updates_per_iter"],
                          async_barrier=True, steps_per_call=1, **kw)
    chunked = loops.train("dqn", "catch", steps_per_call=3, **kw)
    assert torch.backends.cudnn.deterministic
    assert _same_run(fused, sync)
    assert _same_run(sync, barrier)
    assert _same_run(fused, chunked)


# ---------------------------------------------------------------------------
# the DDPG / PPO / A2C slice (``-k algo``)
# ---------------------------------------------------------------------------

# B1's new edge rows on the algorithms' paths: K 2 (MountainCar) and 3
# (Pendulum), N 1 (DDPG's mu head) and 3 (CartPole's logits and value)
ALGO_B1_ROWS = [(m, k, n) for m in (4, 8, 64, 512) for k in (2, 3)
                for n in (1, 3, 64)] + [(m, 64, n) for m in (4, 128, 512)
                                         for n in (1, 3)]


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("mkn", ALGO_B1_ROWS)
def test_int8_matmul_algo_edge_rows_on_card(cuda, bits, mkn):
    """B1 at the K and N edges the algorithms give it: bitwise, one
    launch."""
    m, k, n = mkn
    args = [a.to(cuda) for a in _gemm_inputs(m, k, n, bits, seed=m + k + n)]
    before = int8_matmul.launches.value
    got = int8_matmul.int8_matmul_cuda(*args, w_bits=bits)
    want = int8_matmul.int8_matmul_plain(*args, w_bits=bits)
    torch.cuda.synchronize()
    assert int8_matmul.launches.value == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("net", [(3, 1), (2, 4), (4, 3)],
                         ids=["ddpg-pendulum", "ppo-mountaincar",
                              "ppo-cartpole"])
@pytest.mark.parametrize("m", [1, 8, 16, 32, 128])
def test_fused_qmlp_algo_heads_on_card(cuda, bits, net, m):
    """B2 on the algorithms' calibrated actors: DDPG's 3-64-64-1 (a head
    of width 1), PPO's 2-64-64-4 and 4-64-64-3: bitwise, one launch."""
    k0, n_out = net
    _fused_one_launch(*_fused_case(cuda, k0, (64, 64), n_out, bits, m,
                                   seed=k0 * 10 + n_out + m))


@pytest.mark.parametrize("algo,env,kw", [
    ("ppo", "cartpole", dict(actor_backend="int8")),
    ("a2c", "cartpole", dict(actor_backend="int4", calib_batch=8)),
    ("ddpg", "pendulum", dict(actor_backend="int8")),
    ("ddpg", "pendulum", dict(actor_backend="int4", calib_batch=8)),
    ("ppo", "cartpole", dict(quant=QuantConfig.qat(8, quant_delay=1)))],
    ids=str)
def test_algo_train_on_card_launches_its_kernels(cuda, algo, env, kw):
    """Two iterations of each algorithm on the card: B1 3 a forward of the
    uncalibrated actor, B2 once a calibrated forward and 2 B1 a
    calibration, B5 6 a QAT forward, as ``chip_smoke.py`` counts them."""
    b1, b2, b5 = (c.value for c in (int8_matmul.launches,
                                    fused_qmlp.launches,
                                    fake_quant.launches))
    small = dict(n_envs=4, n_steps=8) if algo != "ddpg" else dict(
        n_envs=4, rollout_steps=4, updates_per_iter=2, buffer_size=512,
        batch_size=16, warmup=8)
    res = loops.train(algo, env, iterations=2, record_every=2,
                      eval_episodes=4, algo_overrides=small, **kw)
    torch.cuda.synchronize()
    cfg = res.algo_cfg
    fwd = 2 * (cfg.rollout_steps if algo == "ddpg"
               else cfg.n_steps + (algo == "ppo"))
    got = [c.value - v for c, v in zip(
        (int8_matmul.launches, fused_qmlp.launches, fake_quant.launches),
        (b1, b2, b5))]
    if "quant" in kw:
        learner = 2 * cfg.epochs * cfg.n_minibatches
        want = [0, 0, 6 * (fwd + learner + res.eval_steps)]
    elif cfg.calib_batch:
        want = [2 * (2 + 1), fwd + res.eval_steps, 0]
    else:
        want = [3 * (fwd + res.eval_steps), 0, 0]
    assert got == want
    assert res.device.type == "cuda" and all(np.isfinite(res.rewards))


# ---------------------------------------------------------------------------
# the sequence actor in training, and checkpoints (-k seq_train)
# ---------------------------------------------------------------------------

SEQ_NET = {"d_model": 32, "n_layers": 2, "d_ff": 64}
SEQ_SMALL = dict(n_envs=8, rollout_steps=4, updates_per_iter=2,
                 buffer_size=256, batch_size=32, warmup=16)


def _seq_site_launches(batch, context=6, feat=27, n_out=3):
    """B5 launches of one QAT forward of the ``SEQ_NET`` policy on
    ``batch`` stacks: a weight and an activation site a dense layer, one
    launch up to 4,096 elements and two above."""
    def site(n):
        return 1 if n <= 4096 else 2
    d, f, rows = SEQ_NET["d_model"], SEQ_NET["d_ff"], batch * context
    block = (4 * (site(d * d) + site(rows * d)) + site(d * f)
             + site(rows * f) + site(f * d) + site(rows * d))
    return (site(feat * d) + site(rows * d) + SEQ_NET["n_layers"] * block
            + site(d * n_out) + site(batch * n_out))


@pytest.mark.parametrize("rows", [8, 16])
def test_seq_train_b3_at_the_training_shapes_on_card(cuda, rows):
    """B3 at catch_seq's behaviour steps in training (8 envs, and 2 actors
    of 8; 8 slots, Dh 32, window 6), ragged pos: one launch, within
    1e-5 of the plain version."""
    pos = np.random.default_rng(rows).integers(0, 8, size=(1, rows))
    _b3_one_launch(_b3_inputs(cuda, 1, rows, 1, 8, 32, pos, lm=False,
                              seed=rows), 6)


@pytest.mark.parametrize("site,shape", [
    ("activation", (32, 6, 32)), ("activation", (32, 6, 64)),
    ("activation", (32, 3)), ("activation", (8, 6, 32)),
    ("weight", (27, 32)), ("weight", (32, 32)), ("weight", (32, 64)),
    ("weight", (64, 32)), ("weight", (32, 3))], ids=str)
@pytest.mark.parametrize("when", list(SITE_STEPS))
def test_seq_train_site_kernel_at_the_training_shapes_on_card(cuda, when,
                                                              site, shape):
    """B5's site kernel at the sequence policy's sites (the TD batch of 32
    stacks, the 8 behaviour envs, every weight): bitwise, one launch up
    to 4,096 elements and two above."""
    step = torch.tensor(SITE_STEPS[when], dtype=torch.int32, device=cuda)
    x = torch.from_numpy(_fq_input("normal", shape, 8, sum(shape))).to(cuda)
    per_site = 1 if x.numel() <= 4096 else 2
    before = fake_quant.launches.value
    if site == "activation":
        state = _site_state(True, cuda)
        got = fake_quant.activation_site_cuda(x, *state, step, SITE_DELAY,
                                              0.999, 8)
        want = fake_quant.activation_site_plain(x, *state, step, SITE_DELAY,
                                                0.999, 8)
    else:
        got = (fake_quant.weight_site_cuda(x, step, SITE_DELAY, 8),)
        want = (fake_quant.weight_site_plain(x, step, SITE_DELAY, 8),)
    torch.cuda.synchronize()
    assert fake_quant.launches.value == before + per_site
    for g, w in zip(got, want):
        assert _same(g, w)


def test_seq_train_qat_int8_on_card_launches_b1_b3_b5(cuda):
    """Two fused QAT iterations of the int8 sequence actor on the card:
    B1 at every dense layer and B3 at every block of each cached
    behaviour step (B1 too at each windowed eval step), B5 at every site
    of both TD forwards."""
    counters = (int8_matmul.launches, int8_cache_attention.launches,
                fake_quant.launches)
    before = [c.value for c in counters]
    res = loops.train("dqn", "catch_seq", iterations=2, record_every=2,
                      eval_episodes=4, actor_backend="int8",
                      quant=QuantConfig.qat(8, quant_delay=2),
                      net_kwargs={"transformer": dict(SEQ_NET)},
                      algo_overrides=dict(SEQ_SMALL))
    torch.cuda.synchronize()
    cfg = res.algo_cfg
    steps, n_l = 2 * cfg.rollout_steps, SEQ_NET["n_layers"]
    got = [c.value - b for c, b in zip(counters, before)]
    assert got == [(2 + 6 * n_l) * (steps + res.eval_steps), n_l * steps,
                   2 * 2 * cfg.updates_per_iter
                   * _seq_site_launches(cfg.batch_size)]
    assert res.device.type == "cuda" and all(np.isfinite(res.rewards))
    assert len(res.state.observers) == 2 + 6 * n_l


@pytest.mark.parametrize("quant", ["none", "qat8:delay=4"])
def test_seq_train_td_update_on_card_equals_cpu(cuda, quant):
    """One TD update of a sequence actor on the card and on the CPU from
    the same state and batch: within 1e-5 (the observers' ranges too).
    The key biases get no gradient in exact arithmetic (softmax ignores
    ``q . b`` added to every logit of a row), so Adam's normalised step
    makes their rounding noise an update of up to the learning rate:
    their moments are held to 1e-5, their params to one step."""
    from repro_torch.rl import buffer as rb
    res = loops.train("dqn", "catch_seq", iterations=3, record_every=3,
                      eval_episodes=2, quant=QuantConfig.parse(quant),
                      net_kwargs={"transformer": dict(SEQ_NET)},
                      algo_overrides=dict(SEQ_SMALL))
    update = dqn.make_td_update(res.env, res.net, res.algo_cfg)
    batch = rb.replay_sample(res.state.extras.replay,
                             torch.Generator(device=cuda).manual_seed(0), 32)
    card, (loss, _) = update(res.state, batch, res.state.extras.replay.size)
    cpu_in = ptq.tree_to(res.state, "cpu")
    cpu, (cpu_loss, _) = update(cpu_in, ptq.tree_to(batch, "cpu"),
                                cpu_in.extras.replay.size)
    assert abs(float(loss) - float(cpu_loss)) <= 1e-5
    lr = res.algo_cfg.lr
    for tree, cpu_tree in ((card.params, cpu.params),
                           (card.opt.m, cpu.opt.m), (card.opt.v, cpu.opt.v),
                           (card.observers, cpu.observers)):
        for (path, x), (_, y) in zip(ptq.tree_tensors(tree),
                                     ptq.tree_tensors(cpu_tree)):
            noise = tree is card.params and path.endswith("/k/b")
            torch.testing.assert_close(x.cpu().to(torch.float32),
                                       y.to(torch.float32), rtol=0,
                                       atol=2 * lr if noise else 1e-5)
    assert len(card.observers) == (0 if quant == "none"
                                   else 2 + 6 * SEQ_NET["n_layers"])


@pytest.mark.parametrize("topo", ["fused", "async"])
def test_seq_train_resume_bitwise_on_card(cuda, tmp_path, topo):
    """The int8 sequence actor trained to 3 with checkpoints and resumed
    to 6 on the card is the run to 6 that was never stopped, bit for bit
    (the KV caches in the env state, the CUDA generators' states, the
    async streams joined for each save)."""
    from repro_torch.core.ptq import tree_flatten
    multi = topo != "fused"
    kw = dict(seed=3, record_every=3, eval_episodes=2, actor_backend="int8",
              net_kwargs={"transformer": dict(SEQ_NET)},
              algo_overrides=dict(SEQ_SMALL), topology=topo,
              num_actors=2 if multi else 1, sync_every=2 if multi else 1)
    d = str(tmp_path / "ckpt")
    full = loops.train("dqn", "catch_seq", iterations=6, **kw)
    loops.train("dqn", "catch_seq", iterations=3, checkpoint_dir=d,
                checkpoint_every=3, **kw)
    res = loops.train("dqn", "catch_seq", iterations=6, checkpoint_dir=d,
                      checkpoint_every=3, resume=True, **kw)
    pa, la = tree_flatten(full.state)
    pb, lb = tree_flatten(res.state)
    assert pa == pb and all(torch.equal(x, y) for x, y in zip(la, lb))
    assert la[0].device.type == "cuda"
    assert (full.rewards, full.divergences, full.actor_lags) == (
        res.rewards, res.divergences, res.actor_lags)


# ---------------------------------------------------------------------------
# the self-healing runtime on the card (-k resilience)
# ---------------------------------------------------------------------------

RZ_SMALL = dict(n_envs=2, rollout_steps=2, updates_per_iter=2,
                buffer_size=64, batch_size=8, warmup=8)
RZ_MATRIX = {
    "fused": ("5:actor_crash@2,straggler@3:delay_s=0.01,nan_grad@4,"
              "bitflip_push@4,crash_commit@3,dropped_sync@2",
              {"actor_crash", "straggler", "nan_grad", "bitflip_push",
               "crash_commit"}, {"dropped_sync"}),
    "async": ("9:actor_crash@2,straggler@3:delay_s=0.01,nan_grad@5,"
              "bitflip_push@4,crash_commit@3,dropped_sync@6",
              {"actor_crash", "straggler", "nan_grad", "bitflip_push",
               "crash_commit", "dropped_sync"}, set()),
}


def _rz_kwargs(topo, *, iterations=6, ckpt_dir=None, ckpt_every=3, **kw):
    """``tests/test_resilience.py``'s ``_kwargs``, on the card."""
    multi = topo != "fused"
    out = dict(algo="dqn", env_name="cartpole", iterations=iterations,
               seed=3, record_every=3, eval_episodes=2,
               actor_backend="int8", algo_overrides=dict(RZ_SMALL),
               net_kwargs=dict(hidden=(16,)), topology=topo,
               num_actors=2 if multi else 1,
               sync_every=2 if multi else 1, checkpoint_dir=ckpt_dir,
               checkpoint_every=ckpt_every if ckpt_dir else 0)
    out.update(kw)
    return out


def _rz_same_params(a, b) -> bool:
    la = ptq.tree_flatten(a.state.params)[1]
    lb = ptq.tree_flatten(b.state.params)[1]
    return la[0].device.type == "cuda" and all(
        torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("topo", sorted(RZ_MATRIX))
def test_resilience_chaos_matrix_on_card(cuda, tmp_path, topo):
    """The reference's chaos matrix on the card: every planned fault
    fires, or is recorded not applicable, as in the reference, and the
    supervised run recovers with shard 0 quarantined."""
    from repro_torch import resilience as rz
    spec, fired, na = RZ_MATRIX[topo]
    plan = rz.FaultPlan.parse(spec)
    res, rep = rz.supervise(
        _rz_kwargs(topo, iterations=8, ckpt_dir=str(tmp_path),
                   ckpt_every=2),
        plan=plan, config=rz.SupervisorConfig(max_retries=4))
    assert rep.status == "ok" and rep.quarantined == [0]
    assert {k for k, _, _ in rep.faults_fired} == fired
    assert {k for k, _, _ in rep.faults_not_applicable} == na
    assert len(rep.faults_fired) + len(rep.faults_not_applicable) \
        == len(plan.faults)
    assert all(np.isfinite(r) for r in res.rewards)


def test_resilience_retry_bitwise_on_card(cuda, tmp_path):
    """A run retried after a NaN is bitwise its clean run on the card."""
    from repro_torch import resilience as rz
    ref = loops.train(**_rz_kwargs("fused"))
    res, rep = rz.supervise(
        _rz_kwargs("fused", ckpt_dir=str(tmp_path), ckpt_every=3),
        plan=rz.FaultPlan.parse("5:nan_grad@4"))
    assert rep.retries == 1 and rep.rollbacks == 0
    assert _rz_same_params(ref, res) and ref.rewards == res.rewards


@pytest.mark.parametrize("backend,calib", [("int8", 0), ("int4", 32)])
def test_resilience_guarded_async_push_on_card(cuda, backend, calib):
    """The guarded async push under its two streams: a bit flipped in a
    snapshot minted on the learner's stream is caught by the CRC and the
    push is minted again, so the run is the bare run bit for bit (a CRC
    reading a half-written snapshot would raise a false IntegrityError or
    let a corrupt one through)."""
    from repro_torch import resilience as rz
    kw = _rz_kwargs("async", iterations=8, actor_backend=backend,
                    calib_batch=calib, num_actors=2, sync_every=2)
    bare = loops.train(**kw)
    inj = rz.FaultInjector(rz.FaultPlan.parse("4:bitflip_push@3:nbits=4"))
    ctx = rz.ResilienceContext(inj)
    guarded = loops.train(**kw, resilience=ctx)
    assert [k for k, _, _ in inj.fired] == ["bitflip_push"]
    assert [e[0] for e in ctx.events] == ["bitflip_push", "push_retry"]
    assert _rz_same_params(bare, guarded)
    assert (bare.rewards, bare.divergences, bare.actor_lags) == (
        guarded.rewards, guarded.divergences, guarded.actor_lags)


def test_resilience_check_finite_one_host_sync_on_card(cuda):
    """``check_finite`` over a learner's params makes one host sync,
    whatever the number of leaves (counted under
    ``set_sync_debug_mode("warn")``); ``all_finite`` makes none."""
    import warnings

    from repro_torch.resilience import guards
    params = networks.init_mlp(networks.mlp_spec(4, (64, 64, 64), 2),
                               torch.Generator().manual_seed(0), cuda)
    assert len(list(ptq.tree_tensors(params))) == 8
    guards.check_finite(params)                    # warm
    torch.cuda.synchronize()
    for fn, want in ((guards.all_finite, 0), (guards.check_finite, 1)):
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn(params)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        syncs = [w for w in seen if "synchroniz" in str(w.message)]
        assert len(syncs) == want, [str(w.message) for w in seen]


def test_resilience_server_worker_restart_on_card(cuda):
    """A worker crash through ``serving_fault_hook`` restarts the worker
    on the card: the crashed batch fails with the typed error and later
    requests are answered through kernel B1."""
    from repro_torch.resilience import faults
    from repro_torch.serving import PolicyServer
    env = make("cartpole")
    params = networks.init_mlp(networks.mlp_spec(4, (64, 64), 2),
                               torch.Generator().manual_seed(0), cuda)
    ctx = faults.ResilienceContext(faults.FaultInjector(
        faults.FaultPlan.parse("5:actor_crash@1")))
    srv = PolicyServer(env.spec, actor_backend="int8", buckets=(8,),
                       max_wait_us=200, fault_hook=ctx.serving_fault_hook(),
                       device="cuda")
    srv.push_params(params)
    obs = np.zeros(4, np.float32)
    sid = srv.open_session()
    before = int8_matmul.launches.value
    with srv:
        assert srv.submit(sid, obs).result(timeout=60) is not None
        with pytest.raises(faults.ActorCrashError):
            srv.submit(sid, obs).result(timeout=60)
        assert srv.submit(sid, obs).result(timeout=60) is not None
    stats = srv.stats()
    assert stats["worker"]["crashes"] == 1 == stats["worker"]["restarts"]
    assert stats["served"] == 2 and "ActorCrashError" in stats["last_error"]
    assert int8_matmul.launches.value - before == 2 * 3


def test_resilience_supervised_convergence_on_card(cuda, tmp_path):
    """``tests/test_resilience.py``'s convergence case at full width on
    the card: DQN on CartPole (4-64-64-2), actor-learner with 2 actors, 60
    iterations, four faults; params and last reward bitwise the clean
    run's."""
    from repro_torch import resilience as rz
    plan = rz.FaultPlan.parse(
        "11:actor_crash@5,nan_grad@10,bitflip_push@15,crash_commit@12")
    kw = dict(algo="dqn", env_name="cartpole", iterations=60, seed=0,
              record_every=20, eval_episodes=4, actor_backend="int8",
              topology="actor-learner", num_actors=2, sync_every=2,
              checkpoint_dir=str(tmp_path), checkpoint_every=5)
    ref = loops.train(**{k: v for k, v in kw.items()
                         if not k.startswith("checkpoint")})
    res, rep = rz.supervise(kw, plan=plan)
    assert rep.status == "ok" and len(rep.faults_fired) == 4
    assert _rz_same_params(ref, res)
    assert res.rewards[-1] == ref.rewards[-1]
