"""Port parity: kernel B4's plain version and ``ops.flash_attention``.

* ``flash_attention.flash_attention_plain`` (the CPU path, and what the
  CUDA kernel is held against on the card) agrees with the JAX package's
  Pallas kernel ``flash_attention_pallas(..., interpret=True)`` and its
  dense oracle ``ref.mha_ref`` within rtol = atol = 1e-5, the reference's
  attention contract (``docs/contracts.md``, "Attention parity");
  measured up to 1.4e-6 against ``mha_ref`` and 2.5e-6 against the
  kernel.  Cases cover causal and not, windows, the soft-cap, end-aligned
  queries (S < T), ragged tails of both the query and the key tiles (the
  Pallas kernel runs with small blocks so the tails are cheap), and D in
  {32, 80, 256}.
* GQA through ``ops.flash_attention`` (query head h reads KV head
  h // G) agrees with the JAX op in interpret mode fed K and V repeated.
* A fully masked query row (S > T, causal) is 0, as ``ref.mha_ref``
  gives; the Pallas kernel does not give 0 there (ROADMAP queue C).
* The CUDA wrapper refuses what it does not take before any launch.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref

TOL = 1e-5


def _qkv(s, t, d, seed, lead_q=(), lead_kv=()):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return (rng.normal(size=lead_q + (s, d)).astype(f32),
            rng.normal(size=lead_kv + (t, d)).astype(f32) * 1.5,
            rng.normal(size=lead_kv + (t, d)).astype(f32))


def _plain_one_head(q, k, v, **kw):
    """The plain version on one head: (S, D) -> (1, S, 1, D) and back."""
    t = [torch.from_numpy(a)[None, :, None] for a in (q, k, v)]
    return fa.flash_attention_plain(*t, **kw)[0, :, 0].numpy()


@pytest.mark.parametrize("s,t,d,causal,window,softcap", [
    (64, 64, 32, True, None, None),
    (150, 150, 80, True, 16, None),      # ragged q and kv tails, window
    (40, 40, 256, False, None, 50.0),    # gemma2's head dim and soft-cap
    (8, 200, 80, True, 64, None),        # end-aligned, S < T
    (130, 130, 32, True, 32, 30.0),      # window and soft-cap together
    (77, 77, 80, False, 20, None),       # non-causal with a window
    (1, 50, 32, True, None, None),       # one decode-like row
    (96, 300, 256, True, None, None),    # end-aligned over ragged kv tiles
])
def test_plain_matches_pallas_interpret_and_mha_ref(s, t, d, causal, window,
                                                    softcap):
    q, k, v = _qkv(s, t, d, seed=s + t + d)
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = _plain_one_head(q, k, v, **kw)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want_ref = np.asarray(jref.mha_ref(jq, jk, jv, **kw))
    want_kernel = np.asarray(jfa.flash_attention_pallas(
        jq, jk, jv, block_q=32, block_kv=64, interpret=True, **kw))
    np.testing.assert_allclose(got, want_ref, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, want_kernel, rtol=TOL, atol=TOL)
    torch.testing.assert_close(
        torch.from_numpy(got),
        ref.mha_ref(*(torch.from_numpy(a) for a in (q, k, v)), **kw),
        rtol=TOL, atol=TOL)


@pytest.mark.parametrize("b,h,kv,s,t,d,window,softcap", [
    (2, 4, 2, 48, 48, 32, 16, None),
    (1, 6, 3, 20, 70, 80, None, 50.0),
    (1, 4, 1, 33, 33, 32, None, None),
])
def test_gqa_op_matches_jax_op_with_kv_repeated(b, h, kv, s, t, d, window,
                                                 softcap):
    q, k, v = _qkv(s, t, d, seed=h * s, lead_q=(b, h), lead_kv=(b, kv))
    g = h // kv
    kw = dict(causal=True, window=window, softcap=softcap)
    want = np.asarray(jops.flash_attention(
        jnp.asarray(q), jnp.asarray(np.repeat(k, g, axis=1)),
        jnp.asarray(np.repeat(v, g, axis=1)), backend="interpret", **kw))
    before = fa.launches.value
    got = ops.flash_attention(
        *(torch.from_numpy(a).permute(0, 2, 1, 3) for a in (q, k, v)), **kw)
    assert fa.launches.value == before        # the CPU path launches nothing
    assert got.shape == (b, s, h, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.permute(0, 2, 1, 3).numpy(), want,
                               rtol=TOL, atol=TOL)


def test_fully_masked_rows_are_zero_as_in_mha_ref():
    """Causal with S = 16 > T = 8: query rows 0-7 precede every key."""
    q, k, v = _qkv(16, 8, 32, seed=3)
    got = _plain_one_head(q, k, v, causal=True)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want = np.asarray(jref.mha_ref(jq, jk, jv, causal=True))
    assert not got[:8].any() and not want[:8].any()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    # the reference's Pallas kernel masks with -1e30 and so averages V over
    # the masked keys there (flash_attention.py:87 says 0): ROADMAP queue C
    kernel = np.asarray(jfa.flash_attention_pallas(jq, jk, jv, causal=True,
                                                   interpret=True))
    assert np.abs(kernel[:8]).max() > 0.1
    np.testing.assert_allclose(kernel[8:], want[8:], rtol=TOL, atol=TOL)


def test_cuda_wrapper_refuses_what_it_does_not_take():
    q = torch.zeros(1, 4, 2, 32)
    kv = torch.zeros(1, 4, 1, 32)
    before = fa.launches.value
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_cuda(q, kv, kv)            # CPU tensors
    assert fa.launches.value == before


def test_plain_bounds_its_logits_per_call(monkeypatch):
    """Heads split across calls give the same result as one call."""
    q, k, v = _qkv(24, 24, 32, seed=5, lead_q=(1, 6), lead_kv=(1, 2))
    args = [torch.from_numpy(a).permute(0, 2, 1, 3) for a in (q, k, v)]
    whole = fa.flash_attention_plain(*args, window=8)
    monkeypatch.setattr(fa, "PLAIN_LOGITS", 24 * 24 * 2)    # 2 heads a call
    split = fa.flash_attention_plain(*args, window=8)
    assert torch.equal(whole, split)
