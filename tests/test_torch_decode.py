"""Kernel B3's launch plan, its split-and-merge arithmetic, and the LM's
strided cache, on the CPU.

* ``int8_cache_attention.plan`` at every ``chip_smoke.CACHE_ROWS`` row:
  the small path (one block a problem, no split) at the sequence actor's
  windows, and at the long and danube 4,096-slot rows enough key splits
  to fill the card's 132 SMs twice, with the scratch the merge needs.
* A plain-torch rehearsal of the split path's order of work: the slots
  chunked as the plan chunks them (from the window's first slot), per
  chunk its max, exponentials, sum and weighted V rows, then the chunks
  merged with the empty-chunk guard (m = -inf, l = 0 adds nothing).  It
  is held within rtol = atol = 1e-5 of ``int8_cache_attention_plain``
  (a dense softmax) on ragged positions, position 0, windows across chunk
  boundaries, chunks wholly outside the valid slots, and problems with
  ``pos < 0``, which give 0.  The kernel itself runs only on the card
  (``tests/test_torch_cuda.py``); this pins the arithmetic it follows.
* ``ops.int8_cache_attention`` on the LM's ``(B, T, KV, Dh)`` cache seen
  through ``transpose(1, 2)`` -- what the decode step passes, read in
  place on the card -- is bitwise its result on contiguous copies, and
  within 1e-5 of the JAX op (``ref`` and interpret-mode Pallas) on the
  same numpy arrays.
"""
import importlib.util
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.core import affine
from repro_torch.kernels import int8_cache_attention as ca
from repro_torch.kernels import ops

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

SMS = 132
SMEM = 232448
TOL = 1e-5


@pytest.mark.parametrize("row", chip_smoke.CACHE_ROWS,
                         ids=lambda r: f"{r[0]}-{r[7]}")
def test_plan_at_the_chip_smoke_rows(row):
    label, nb, nh, g, t, dh, window, _, _ = row
    r = nb * nh
    p = ca.plan(r, g, t, dh, window)
    n_max = min(t, window) if window else t
    assert p["splits"] * p["per"] >= n_max
    if label.startswith(("airnav_seq", "catch_seq")):  # the seq actors
        assert p["path"] == "small" and p["splits"] == 1
        assert p["blocks"] == r and p["scratch"] == 0
        return
    assert p["path"] == "split" and p["smem"] <= SMEM
    assert p["per"] % p["tile"] == 0 or p["splits"] == 1
    if t >= 4096 or (r < SMS and n_max >= 2 * p["tile"]):
        # few problems over many slots: a wave of blocks on every SM where
        # the tiles allow it, no more than the SMs keep in flight unless
        # the chunk limit forces more splits
        assert p["splits"] > 1
        assert p["blocks"] >= min(SMS, r * (n_max // p["tile"]))
        assert p["blocks"] <= max(ca.BLOCKS_PER_SM * SMS + r,
                                  r * math.ceil(n_max / ca.PER_MAX))
        assert p["scratch"] == 4 * r * p["splits"] * g * (
            2 + 4 * math.ceil(dh / 4))
    else:
        assert p["splits"] == 1 and p["scratch"] == 0


def test_serve_rows_at_the_serve_runs_cache():
    """The B3 rows that stand for chip_smoke's serve runs read the cache
    those runs build: prompt plus new tokens of ``LM_SERVE_ARGS``."""
    args = chip_smoke.LM_SERVE_ARGS
    slots = sum(int(args[args.index(f) + 1])
                for f in ("--prompt-len", "--new-tokens"))
    serve = [r for r in chip_smoke.CACHE_ROWS if r[0].endswith(" serve")]
    assert len(serve) == 3 and all(r[4] == slots for r in serve)


def test_plan_splits_follow_the_problems():
    """Few problems split wide, many not at all; a window bounds the
    slots a problem reads; very long caches split by the chunk limit."""
    assert ca.plan(8, 4, 4096, 128)["splits"] == 32
    assert ca.plan(32, 4, 4096, 80)["splits"] == 8
    assert ca.plan(512, 4, 4096, 80)["splits"] == 4096 // ca.PER_MAX
    assert ca.plan(600, 4, 1000, 80)["splits"] == 1
    assert ca.plan(2, 4, 4096, 80, 200)["splits"] == 1
    long = ca.plan(1, 4, 1 << 17, 80)
    assert long["per"] <= ca.PER_MAX
    assert long["splits"] * long["per"] >= 1 << 17
    big = ca.plan(1, 16, 65536, 256)
    assert big["smem"] <= SMEM and big["splits"] * big["per"] >= 65536


def _inputs(r, g, t, dh, seed):
    """q, and K and V quantized by the cache's own quantizer, as the
    on-card tests make them (tests/test_torch_cuda.py)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    kc, ks = affine.quantize_symmetric(torch.from_numpy(
        rng.normal(size=(r, t, dh)).astype(f32) * 3.0))
    vc, vs = affine.quantize_symmetric(torch.from_numpy(
        rng.normal(size=(r, t, dh)).astype(f32)))
    return (torch.from_numpy(rng.normal(size=(r, g, dh)).astype(f32)),
            kc, ks, vc, vs)


def rehearse(q, kc, ks, vc, vs, pos, window, splits, per):
    """The split path's arithmetic in plain torch, problem by problem."""
    r_n, g, dh = q.shape
    t_n = kc.shape[1]
    scale = dh ** -0.5
    out = torch.zeros_like(q)
    for r in range(r_n):
        p = int(pos[r])
        hi = min(p, t_n - 1)
        lo = max(0, p - window + 1) if window else 0
        parts = []
        for c in range(splits):
            first = lo + c * per
            n = max(0, min(hi, first + per - 1) - first + 1)
            if n == 0:
                parts.append((torch.full((g,), -math.inf),
                              torch.zeros(g), torch.zeros(g, dh)))
                continue
            sl = slice(first, first + n)
            dot = q[r] @ kc[r, sl].to(torch.float32).T           # (G, n)
            s = dot * (ks[r, sl, 0] * scale)
            m = s.max(dim=-1).values
            e = torch.exp(s - m[:, None])
            w = e * vs[r, sl, 0]
            parts.append((m, e.sum(-1), w @ vc[r, sl].to(torch.float32)))
        ms = torch.stack([m for m, _, _ in parts])              # (S, G)
        ls = torch.stack([l for _, l, _ in parts])
        accs = torch.stack([a for _, _, a in parts])            # (S, G, Dh)
        big = torch.where(ls > 0, ms, torch.full_like(ms, -math.inf)).max(0)
        f = torch.where(ls > 0, torch.exp(ms - big.values),
                        torch.zeros_like(ms))
        lsum = (ls * f).sum(0)
        acc = (accs * f[..., None]).sum(0)
        out[r] = torch.where(lsum[:, None] > 0,
                             acc / lsum[:, None].clamp(min=1e-30),
                             torch.zeros_like(acc))
    return out


# (R, G, T, Dh, window, positions, splits, per); splits None: the plan's
REHEARSALS = [
    (2, 4, 1000, 80, None, [999, 0], None, None),
    (3, 4, 4096, 32, None, [4095, 2049, 5], None, None),
    (4, 2, 100, 16, None, [99, 50, 0, 17], 7, 16),       # past the valid
    (3, 4, 100, 16, 30, [99, 40, 10], 3, 16),            # window crosses
    (3, 1, 300, 8, 100, [299, 150, 64], 5, 32),
    (2, 8, 64, 24, None, [63, 31], 4, 16),
    (3, 3, 2000, 40, 700, [1999, 700, 3], None, None),
    (2, 4, 50, 16, None, [-1, 49], 4, 16),               # pos < 0: 0
]


@pytest.mark.parametrize("case", REHEARSALS, ids=lambda c: (
    f"R{c[0]}-G{c[1]}-T{c[2]}-Dh{c[3]}-w{c[4]}-S{c[6]}"))
def test_split_merge_rehearsal_within_contract_of_plain(case):
    r, g, t, dh, window, pos, splits, per = case
    if splits is None:
        p = ca.plan(r, g, t, dh, window)
        splits, per = p["splits"], p["per"]
        assert splits > 1
    n_max = min(t, window) if window else t
    assert splits * per >= n_max
    args = _inputs(r, g, t, dh, seed=t + g)
    pos = torch.tensor(pos, dtype=torch.int32)
    got = rehearse(*args, pos, window, splits, per)
    want = ca.int8_cache_attention_plain(*args, pos, window)
    valid = pos >= 0
    torch.testing.assert_close(got[valid], want[valid], rtol=TOL, atol=TOL)
    assert not bool(got[~valid].any())


def test_rehearsal_skips_chunks_outside_the_valid_slots():
    """Chunks past pos (and a whole problem at pos 0) hold no slot: their
    (m, l) = (-inf, 0) must add nothing, not NaN."""
    args = _inputs(2, 2, 64, 8, seed=3)
    pos = torch.tensor([0, 3], dtype=torch.int32)
    got = rehearse(*args, pos, None, 8, 8)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(
        got, ca.int8_cache_attention_plain(*args, pos), rtol=TOL, atol=TOL)


def _lm_cache(b, t, kv, g, dh, seed):
    """An LM decode cache (B, T, KV, Dh) with its scales, and q (B, KV,
    G, Dh), as numpy arrays."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return (rng.normal(size=(b, kv, g, dh)).astype(f32),
            rng.integers(-127, 128, size=(b, t, kv, dh)).astype(np.int8),
            rng.uniform(0.01, 0.1, size=(b, t, kv, 1)).astype(f32),
            rng.integers(-127, 128, size=(b, t, kv, dh)).astype(np.int8),
            rng.uniform(0.01, 0.1, size=(b, t, kv, 1)).astype(f32))


# (B, T, KV, G, Dh, pos, window)
LM_CASES = [
    (4, 64, 8, 4, 16, 63, None),
    (2, 40, 2, 2, 8, [39, 7], None),
    (3, 33, 2, 4, 12, 20, 9),
]


@pytest.mark.parametrize("case", LM_CASES, ids=str)
def test_lm_views_bitwise_their_contiguous_copies(case):
    b, t, kv, g, dh, pos, window = case
    q, kc, ks, vc, vs = map(torch.from_numpy, _lm_cache(b, t, kv, g, dh, t))
    views = [x.transpose(1, 2) for x in (kc, ks, vc, vs)]
    assert not views[0].is_contiguous()
    pos = torch.tensor(pos)
    got = ops.int8_cache_attention(q, *views, pos, window=window)
    want = ops.int8_cache_attention(q, *[x.contiguous() for x in views],
                                    pos, window=window)
    assert torch.equal(got, want)


@pytest.mark.parametrize("backend", ["ref", "interpret"])
@pytest.mark.parametrize("case", LM_CASES, ids=str)
def test_lm_views_within_contract_of_jax(case, backend):
    b, t, kv, g, dh, pos, window = case
    q, kc, ks, vc, vs = _lm_cache(b, t, kv, g, dh, t)
    pos = np.asarray(pos, np.int32)
    t_views = [torch.from_numpy(x).transpose(1, 2) for x in (kc, ks, vc, vs)]
    got = ops.int8_cache_attention(torch.from_numpy(q), *t_views,
                                   torch.from_numpy(pos), window=window)
    j_views = [jnp.asarray(x).transpose(0, 2, 1, 3) for x in (kc, ks, vc, vs)]
    want = np.asarray(jops.int8_cache_attention(
        jnp.asarray(q), *j_views, jnp.asarray(pos), window=window,
        backend=backend))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
