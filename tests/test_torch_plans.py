"""The launch plans of kernels B4 and B2, and B4's 3xTF32 arithmetic.

* ``flash_attention.plan`` at every ``chip_smoke.FLASH_ROWS`` row and
  ``fused_qmlp.plan`` at every B2 row of ``chip_smoke.py``: shared memory
  within one H100 block's 232,448 bytes, a legal cluster size, and
  enough blocks to fill the card's 132 SMs where the shape allows.
* The 3xTF32 split that B4 runs on the tensor cores, emulated here in
  plain torch (tf32 rounding by bit arithmetic on an int32 view: big is
  rounded to nearest with ties away from zero, as ``cvt.rna.tf32.f32``;
  the small half ``a - big`` is cut to its top 11 bits, as the tensor
  cores take a tf32 operand), stays within rtol = atol = 1e-5 of
  ``flash_attention_plain`` at the reduced shapes of the on-card tests.
  The emulation lives here only; no path uses it.  It rehearses on the
  CPU the tolerance that the kernel is held to on the card
  (``tests/test_torch_cuda.py``).
"""
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_qmlp as fq
from repro_torch.kernels import ref
from repro_torch.rl import actorq, networks

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

SMS = 132
SMEM = 232448


@pytest.mark.parametrize("row", chip_smoke.FLASH_ROWS, ids=lambda r: r[0])
def test_flash_plan_at_the_chip_smoke_rows(row):
    _, b, h, kv, s, t, d, causal, window, _ = row
    p = fa.plan(b, s, t, h, kv, d, causal=causal, window=window)
    assert p["smem"] <= SMEM
    assert p["cluster"] in (1, 2, 4, 8) and p["bq"] % p["cluster"] == 0
    assert p["d_padded"] >= d and p["d_padded"] % 16 == 0
    items = b * kv * p["tiles"]
    assert p["tiles"] * p["bq"] >= s * (h // kv)
    assert p["blocks"] == items * p["cluster"]
    # the card is filled, or the cluster is as large as the keys allow
    largest = max(c for c in (1, 2, 4, 8)
                  if c == 1 or p["key_tiles"] >= 2 * c)
    assert p["blocks"] >= SMS or p["cluster"] == largest


def test_flash_plan_splits_short_query_blocks_only():
    """The end-aligned row packs its 4 query heads into one tile and
    splits the keys 8 ways; the danube prefill fills the card unsplit."""
    end = fa.plan(1, 8, 4096, 32, 8, 80)
    assert end["tiles"] == 1 and end["cluster"] == 8 and end["blocks"] == 64
    pre = fa.plan(1, 8192, 8192, 32, 8, 80, window=4096)
    assert pre["cluster"] == 1 and pre["blocks"] == 2048
    assert fa.plan(1, 16, 8, 2, 1, 32)["key_tiles"] == 1


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plan_fills_the_card_or_takes_the_largest_cluster(d, causal):
    """Over batches, heads and lengths around the card's 132 SMs, a plan
    whose blocks leave SMs idle has the largest cluster the keys allow."""
    for b in (1, 2, 4, 8):
        for kv, g in ((1, 1), (6, 1), (8, 6), (8, 8)):
            for s, t in ((1, 1500), (1, 64), (448, 1500), (2048, 1601),
                         (16, 100)):
                p = fa.plan(b, s, t, kv * g, kv, d, causal=causal)
                largest = max(c for c in (1, 2, 4, 8)
                              if c == 1 or p["key_tiles"] >= 2 * c)
                assert p["blocks"] >= SMS or p["cluster"] == largest


@pytest.mark.parametrize("d,want", [(1, 16), (16, 16), (17, 32), (40, 48),
                                    (64, 64), (80, 80), (81, 256),
                                    (200, 256), (256, 256)])
def test_flash_head_dim_padding(d, want):
    assert fa._padded_d(d) == want
    assert fa.plan(1, 8, 8, 1, 1, d)["consumers"] == (1 if want > 80 else 2)


def _b2_layers(k0, widths, n_out, bits, seed=0):
    gen = torch.Generator().manual_seed(seed)
    params = networks.init_mlp(networks.mlp_spec(k0, widths, n_out), gen,
                               "cpu")
    cache = actorq.calibrate_actor_cache(
        actorq.pack_actor_params(params, bits),
        torch.randn(16, k0, generator=gen) * 0.5)
    return actorq._fused_layers(cache, len(widths))


# chip_smoke's B2 rows: Policies II and III on AirNav (9 -> 25) at M 8 and
# 512, and the training runs' CartPole net at M 8 (one actor's envs) and
# 32 (the topology runs' 4 actors x 8 envs)
_POLICIES = chip_smoke.quarl_atari()
B2_ROWS = [("II", 9, _POLICIES.DEPLOY_POLICY_II.widths, 25, m)
           for m in (8, 512)] + \
    [("III", 9, _POLICIES.DEPLOY_POLICY_III.widths, 25, m)
     for m in (8, 512)] + \
    [("cartpole", 4, (64, 64), 2, m) for m in (8, 32)]


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("row", B2_ROWS, ids=lambda r: f"{r[0]}-{r[4]}")
def test_fused_qmlp_plan_at_the_chip_smoke_rows(row, bits):
    name, k0, widths, n_out, m = row
    layers = _b2_layers(k0, widths, n_out, bits)
    p = fq.plan(m, k0, layers)
    assert p["smem"] <= SMEM and p["cluster"] == 1
    assert p["blocks"] == -(-m // fq.ROWS)
    assert p["stride"] % 32 == 16
    assert p["stride"] >= max([k0] + list(widths)) + 16
    assert p["red"] + fq.RED_BYTES <= min(
        o for o in p["staged"] + [p["smem"]] if o >= 0)
    staged = [o >= 0 for o in p["staged"]]
    if name == "III":     # its 2 MB and 512 KB layers stream from L2
        assert staged[1:3] == [False, False]
    else:                 # every other net sits whole in shared memory
        assert all(staged)
    offs = [o for o in p["staged"] if o >= 0]
    assert all(o % 16 == 0 for o in offs) and offs == sorted(offs)


# --- 3xTF32, emulated ------------------------------------------------------

def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to tf32 (10 mantissa bits), to nearest with ties away
    from zero: add half of the dropped 13 bits to the magnitude's bit
    pattern, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_cut(x: torch.Tensor) -> torch.Tensor:
    """Keep the top 11 significant bits of float32 (clear the low 13)."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as big.big + big.small + small.big, each operand split into
    big = tf32(a) and small = a - big, of which the products see the top
    11 bits.  Each of the three products is summed in float64 and rounded
    to float32 once (an 11-bit by 11-bit product is exact in float64), then
    the small terms are added first, as the kernel adds them: a float32
    BLAS would make the result depend on its blocking and on the process's
    float32 matmul precision, which oneDNN may lower to bf16 or tf32."""
    ab = tf32(a)
    as_ = tf32_cut(a - ab)
    bb = tf32(b)
    bs = tf32_cut(b - bb)

    def mm(x, y):
        return (x.double() @ y.double()).float()
    return mm(as_, bb) + mm(ab, bs) + mm(ab, bb)


def emulate_3xtf32(q, k, v, *, causal=True, window=None, softcap=None):
    """Attention with both products in 3xTF32, the softmax in float32."""
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = h // kv
    mask = ref.attention_mask(s, t, causal=causal, window=window)
    out = torch.zeros_like(q)
    for hh in range(h):
        x = mm_3xtf32(q[:, :, hh], k[:, :, hh // g].transpose(1, 2))
        x = x * (1.0 / math.sqrt(d))
        if softcap:
            x = softcap * torch.tanh(x / softcap)
        x = torch.where(mask, x, torch.tensor(-math.inf))
        mx = x.amax(-1, keepdim=True)
        p = torch.exp(x - torch.where(mx == -math.inf, 0.0, mx))
        den = p.sum(-1, keepdim=True)
        o = mm_3xtf32(p, v[:, :, hh // g])
        out[:, :, hh] = torch.where(den > 0, o / den, 0.0)
    return out


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10                 # the tf32 step above 1
    x = torch.tensor([1.0 + 2.0 ** -11,          # a tie: away from zero
                      -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -11 - 2.0 ** -23,   # below the tie
                      one, 3.0e-7], dtype=torch.float32)
    got = tf32(x)
    assert got[:4].tolist() == [one, -one, 1.0, one]
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    small = tf32(x - got)                  # x - big is exact
    torch.testing.assert_close(got + small, x, rtol=2.0 ** -21, atol=0)


# the reduced shapes of tests/test_torch_cuda.py's B4 rows, then its
# key-split rows: (B, H, KV, S, T, D, causal, window, softcap)
EMU_ROWS = [
    (1, 8, 2, 512, 512, 80, True, 128, None),
    (1, 4, 2, 512, 512, 256, True, 128, 50.0),
    (1, 4, 2, 384, 384, 256, True, None, 50.0),
    (1, 6, 6, 300, 300, 64, False, None, None),
    (1, 8, 2, 8, 1024, 80, True, None, None),
    (2, 4, 4, 1000, 1000, 32, True, None, None),
    (1, 2, 1, 16, 8, 32, True, None, None),
    (1, 2, 1, 70, 90, 40, True, 20, None),
    (1, 2, 2, 65, 65, 200, False, 30, 30.0),
    (3, 3, 1, 1, 77, 16, True, 5, None)] + [
    (1, h, kv, s, 4096, d, True, None, None)
    for s in (1, 8) for h, kv in ((8, 2), (2, 2)) for d in (40, 64, 80, 256)]


@pytest.mark.parametrize("shape", EMU_ROWS, ids=str)
def test_3xtf32_emulation_within_contract_of_plain(shape):
    b, h, kv, s, t, d, causal, window, softcap = shape
    rng = np.random.default_rng(s + t + d)
    q, k, v = (torch.from_numpy(rng.normal(size=sh).astype(np.float32))
               for sh in ((b, s, h, d), (b, t, kv, d), (b, t, kv, d)))
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = emulate_3xtf32(q, k, v, **kw)
    want = fa.flash_attention_plain(q, k, v, **kw)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    # one tf32 product alone would not hold the contract
    if d >= 64 and s * t > 4096:
        one = tf32(q[:, :, 0]) @ tf32(k[:, :, 0]).transpose(1, 2)
        full = q[:, :, 0] @ k[:, :, 0].transpose(1, 2)
        assert float((one - full).abs().max()) > 1e-3
