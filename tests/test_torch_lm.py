"""Port parity: the LM inference path (configs, attention layer, blocks,
transformer prefill and decode, PTQ of the LM tree, the serve launcher).

The same params (drawn by the JAX package, carried across with
``transformer.params_from_jax``) and the same tokens go through the JAX
package and the port on the CPU.  Tolerances, with what was measured:

* ``attention_layer`` prefill and fp-cache decode, ``prefill``,
  ``forward`` and ``decode_step`` with an fp cache: rtol = atol = 1e-5
  (measured up to 4.2e-6 on logits of size up to 3.0): float attention
  and matmuls summed in another order.
* int8-cache decode: the K/V token quantizer is bitwise given equal
  inputs, but the projections feeding it differ by an ulp, which can move
  one code (ROADMAP queue C, the code flips of the sequence actor).  Held
  as ``tests/test_torch_seq.py`` holds them: every logit within
  ``FLIP_ATOL`` = 5e-3 and at least ``TIGHT_SHARE`` = 75% of them within
  1e-5.  Measured at these inputs: no flip, 3.1e-6 at most; with other
  params (JAX ``PRNGKey(0)``) gemma2, whose soft-cap sends the int8 cache
  through the dense path, showed one, 9.1e-4.
* ``ptq_simulate`` on the LM tree: bitwise.
* prefill against 40 token-by-token fp-cache ``decode_step``s inside the
  port: 2e-2, the reference's contract (``tests/test_arch_smoke.py:155-186``);
  the int8 cache against the fp cache: correlation above 0.99, the
  reference's (``:188-207``).

The reduced danube prefill at S = 4096 takes the JAX package's
``chunked_attention`` branch (S > 2048); the port runs every S through
``ops.flash_attention``.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcfgs
from repro.core import fake_quant as jfq
from repro.core import ptq as jptq
from repro.core.qconfig import QuantConfig as JQuantConfig
from repro.models import attention as jattn
from repro.models import transformer as jtr
from repro_torch.configs import base as cfgs
from repro_torch.core import ptq
from repro_torch.core.fake_quant import NullQATContext
from repro_torch.core.qconfig import QuantConfig
from repro_torch.kernels import (fake_quant, flash_attention,
                                 int8_cache_attention)
from repro_torch.launch import serve
from repro_torch.models import attention, blocks, common, transformer

ARCHS = ["h2o-danube-1.8b", "gemma2-9b"]
# the MoE, recurrent and other dense configs (tests/test_torch_lm_families.py)
FAMILIES = ["recurrentgemma-2b", "xlstm-125m", "mixtral-8x7b",
            "codeqwen1.5-7b", "stablelm-12b"]
# the encoder and cross-attention configs and grok-1
# (tests/test_torch_lm_frontends.py)
FRONTENDS = ["whisper-tiny", "llama-3.2-vision-90b", "grok-1-314b"]
TOL = 1e-5
FLIP_ATOL = 5e-3
TIGHT_SHARE = 0.75


def _models(name, seed=0):
    jcfg, cfg = jcfgs.get_reduced(name), cfgs.get_reduced(name)
    jp = jtr.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = transformer.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                     "cpu")
    return jcfg, cfg, jp, tp


def _tokens(b, s, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


# ---------------------------------------------------------------------------
# configs and params
# ---------------------------------------------------------------------------

def _fields(c):
    out = dataclasses.asdict(c)
    out["quant"] = {k: getattr(v, "value", v) for k, v in out["quant"].items()}
    return out


@pytest.mark.parametrize("name", ARCHS)
def test_configs_are_the_references(name):
    for get in ("get", "get_reduced"):
        j, t = getattr(jcfgs, get)(name), getattr(cfgs, get)(name)
        assert _fields(t) == _fields(j)
        assert (t.hd, t.pattern_repeats, t.pattern_remainder) == \
            (j.hd, j.pattern_repeats, j.pattern_remainder)
        assert t.n_params() == j.n_params()
        assert t.n_active_params() == j.n_active_params()
    assert cfgs.INPUT_SHAPES.keys() == jcfgs.INPUT_SHAPES.keys()
    assert cfgs.names() == sorted(ARCHS + FAMILIES + FRONTENDS)


def test_unported_configs_and_kinds_raise():
    """Every LM config of the reference is ported: nothing is left
    unported, an unknown name still raises, and the encoder and
    cross-attention kinds build on any config."""
    assert set(cfgs.names()) == set(jcfgs.names()) - {"quarl-atari"}
    for name in FRONTENDS:
        assert cfgs.get(name).name == name
        assert cfgs.get_reduced(name).name == f"{name}-reduced"
    with pytest.raises(KeyError):
        cfgs.get("no-such-arch")
    cfg = cfgs.get_reduced("h2o-danube-1.8b")
    assert {"cross", "norm_cross"} <= set(blocks.block_spec(cfgs.CROSS,
                                                            cfg))
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     "cpu")
    spec = transformer.param_specs(dataclasses.replace(cfg, encoder_layers=1))
    assert spec["encoder"]["b0_attn"]["attn"]["q"]["w"].shape == \
        (1, cfg.d_model, cfg.n_heads * cfg.hd)
    # LM training is ported: a QAT forward returns the observers
    qat = dataclasses.replace(cfg, quant=QuantConfig.qat(8))
    coll = transformer.init_qat_collection(qat, "cpu")
    _, _, new = transformer.forward(qat, params, torch.zeros(
        1, 4, dtype=torch.long), qat_collection=coll)
    assert set(new) == set(coll)
    # --rl-env (item 10) is ported: the launcher trains and serves
    assert serve.main(["--rl-env", "cartpole", "--rl-iters", "1",
                       "--serve-sessions", "2", "--serve-steps", "1",
                       "--device", "cpu"]) == 0


def _spec_shapes(tree, leaf):
    if isinstance(tree, dict):
        return {k: _spec_shapes(v, leaf) for k, v in tree.items()}
    return leaf(tree)


@pytest.mark.parametrize("name", ARCHS)
def test_param_specs_and_init_follow_the_reference(name):
    jcfg, cfg = jcfgs.get_reduced(name), cfgs.get_reduced(name)
    spec = transformer.param_specs(cfg)
    jspec = jtr.param_specs(jcfg)
    def shape_init(p):
        return tuple(p.shape), p.init
    assert _spec_shapes(spec, shape_init) == jax.tree_util.tree_map(
        shape_init, jspec, is_leaf=lambda x: isinstance(x, type(
            jspec["embed"]["w"])))
    a = transformer.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    b = transformer.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    assert all(torch.equal(x, y) for (_, x), (_, y) in
               zip(ptq.tree_tensors(a), ptq.tree_tensors(b)))
    assert not a["final_norm"]["scale"].any()
    assert abs(float(a["embed"]["w"].std()) - 0.02) < 2e-3
    w = a["layers"]["b0_attn_local"]["attn"]["q"]["w"]
    assert abs(float(w.std()) * cfg.d_model ** 0.5 - 1.0) < 0.05
    ln = common.init_params(common.layer_norm_spec(8),
                            torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(ln["scale"], torch.ones(8)) and not ln["bias"].any()


def test_layer_norm_rope_and_dense_match_jax():
    from repro.models import common as jcommon
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 4000, size=(2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos)).numpy(),
        np.asarray(jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos))),
        rtol=TOL, atol=TOL)
    p = {"scale": rng.normal(size=16).astype(np.float32),
         "bias": rng.normal(size=16).astype(np.float32)}
    np.testing.assert_allclose(
        common.layer_norm({k: torch.from_numpy(v) for k, v in p.items()},
                          torch.from_numpy(x)).numpy(),
        np.asarray(jcommon.layer_norm(p, jnp.asarray(x))), rtol=TOL,
        atol=TOL)


# ---------------------------------------------------------------------------
# the attention layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("window,softcap", [(8, None), (None, 50.0)])
def test_attention_layer_matches_jax(int8, window, softcap):
    """Prefill of 20 tokens, then 12 decode steps into a ring of 8 slots
    (window 8) or a plain cache (no window)."""
    d, h, kv, hd, b = 64, 4, 2, 16, 2
    rng = np.random.default_rng(7)
    f32 = np.float32
    p = {n: {"w": (rng.normal(size=shape) / np.sqrt(shape[0])).astype(f32)}
         for n, shape in (("q", (d, h * hd)), ("k", (d, kv * hd)),
                          ("v", (d, kv * hd)), ("o", (h * hd, d)))}
    tp = {n: {"w": torch.from_numpy(w["w"])} for n, w in p.items()}
    kw = dict(n_heads=h, n_kv=kv, head_dim=hd, window=window,
              softcap=softcap)
    x = rng.normal(size=(b, 20, d)).astype(f32)
    want, _ = jattn.attention_layer(jfq.NullQATContext(), p, jnp.asarray(x),
                                    **kw)
    got, _ = attention.attention_layer(NullQATContext(), tp,
                                       torch.from_numpy(x), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    size = window or 12
    jc = jattn.init_cache(b, size, kv, hd, int8=int8, dtype=jnp.float32)
    tc = attention.init_cache(b, size, kv, hd, int8=int8, device="cpu")
    diffs = []
    for pos in range(12):
        xt = x[:, pos:pos + 1]
        want, jc = jattn.attention_layer(jfq.NullQATContext(), p,
                                         jnp.asarray(xt), cache=jc,
                                         pos=jnp.asarray(pos), **kw)
        got, tc = attention.attention_layer(NullQATContext(), tp,
                                            torch.from_numpy(xt), cache=tc,
                                            pos=pos, **kw)
        diffs.append(np.abs(got.numpy() - np.asarray(want)))
        np.testing.assert_array_equal(tc.positions.numpy(),
                                      np.asarray(jc.positions))
    diffs = np.stack(diffs)
    if int8:
        assert diffs.max() <= FLIP_ATOL and (diffs <= TOL).mean() >= \
            TIGHT_SHARE
    else:
        assert diffs.max() <= TOL


def test_int8_decode_goes_through_the_b3_op_and_softcap_does_not(
        monkeypatch):
    calls = []
    real = attention.ops.int8_cache_attention
    monkeypatch.setattr(attention.ops, "int8_cache_attention",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    for name, want in (("h2o-danube-1.8b", 2), ("gemma2-9b", 0)):
        cfg = dataclasses.replace(
            cfgs.get_reduced(name),
            quant=dataclasses.replace(QuantConfig.none(), int8_kv_cache=True))
        params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                         "cpu")
        caches = transformer.init_caches(cfg, 1, 40, device="cpu")
        calls.clear()
        transformer.decode_step(cfg, params, torch.zeros(1, 1,
                                                         dtype=torch.long),
                                caches, 0)
        assert len(calls) == want
    # danube's ring (40 slots > window 32) is 32 slots: no window term
    assert calls == [] or all(k["window"] is None for k in calls)


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,s", [("h2o-danube-1.8b", 64),
                                    ("gemma2-9b", 64),
                                    ("h2o-danube-1.8b", 4096)])
def test_prefill_matches_jax(name, s):
    jcfg, cfg, jp, tp = _models(name)
    b = 2 if s <= 64 else 1
    toks = _tokens(b, s, cfg.vocab, seed=s)
    want = np.asarray(jtr.prefill(jcfg, jp, jnp.asarray(toks)))
    got = transformer.prefill(cfg, tp, torch.from_numpy(toks).long())
    assert got.shape == (b, 1, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", ARCHS)
def test_forward_logits_match_jax(name):
    jcfg, cfg, jp, tp = _models(name, seed=2)
    toks = _tokens(2, 24, cfg.vocab, seed=11)
    want, _, _ = jtr.forward(jcfg, jp, jnp.asarray(toks))
    got, _, _ = transformer.forward(cfg, tp, torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("name", ARCHS)
def test_decode_episode_matches_jax(name, int8):
    """12 teacher-forced decode tokens; danube's cache (12 slots < window
    32) is plain, so B3 takes the window term."""
    jcfg, cfg, jp, tp = _models(name, seed=1)
    toks = _tokens(2, 12, cfg.vocab, seed=3)
    jc = jtr.init_caches(jcfg, 2, 12, int8=int8, dtype=jnp.float32)
    tc = transformer.init_caches(cfg, 2, 12, int8=int8, device="cpu")
    step = jax.jit(lambda p, t, c, pos: jtr.decode_step(jcfg, p, t, c, pos))
    diffs = []
    for pos in range(12):
        want, jc = step(jp, jnp.asarray(toks[:, pos:pos + 1]), jc,
                        jnp.asarray(pos))
        got, tc = transformer.decode_step(
            cfg, tp, torch.from_numpy(toks[:, pos:pos + 1]).long(), tc, pos)
        diffs.append(np.abs(got.numpy() - np.asarray(want)))
    diffs = np.stack(diffs)
    if int8:
        assert diffs.max() <= FLIP_ATOL
        assert (diffs <= TOL).mean() >= TIGHT_SHARE
    else:
        assert diffs.max() <= TOL


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_matches_token_by_token_decode(name):
    """40 tokens: danube's local layers decode through a 32-slot ring."""
    cfg = cfgs.get_reduced(name)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(4),
                                     "cpu")
    toks = torch.from_numpy(_tokens(1, 40, cfg.vocab, seed=4)).long()
    full, _, _ = transformer.forward(cfg, params, toks)
    caches = transformer.init_caches(cfg, 1, 40, device="cpu")
    for pos in range(40):
        logits, caches = transformer.decode_step(cfg, params,
                                                 toks[:, pos:pos + 1],
                                                 caches, pos)
        torch.testing.assert_close(logits[0, 0], full[0, pos], rtol=2e-2,
                                   atol=2e-2)
    torch.testing.assert_close(
        transformer.prefill(cfg, params, toks), full[:, -1:], rtol=TOL,
        atol=TOL)


@pytest.mark.parametrize("name", ARCHS)
def test_int8_cache_decode_close_to_fp(name):
    """The reference's contract (``tests/test_arch_smoke.py:188-207``):
    after 8 tokens the int8-cache logits correlate above 0.99 with the fp
    cache's."""
    cfg = cfgs.get_reduced(name)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     "cpu")
    toks = torch.from_numpy(_tokens(1, 8, cfg.vocab, seed=1)).long()
    out = {}
    for int8 in (False, True):
        caches = transformer.init_caches(cfg, 1, 8, int8=int8, device="cpu")
        for pos in range(8):
            logits, caches = transformer.decode_step(
                cfg, params, toks[:, pos:pos + 1], caches, pos)
        out[int8] = logits.ravel().numpy()
    assert np.corrcoef(out[False], out[True])[0, 1] > 0.99


# ---------------------------------------------------------------------------
# PTQ of the LM tree and the serve launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["ptq_int8", "ptq_int4", "ptq_fp16"])
def test_ptq_simulate_on_the_lm_tree_is_bitwise_jax(spec):
    """Every float leaf of two dims or more, the stacked norm gains
    ``(layers, d)`` included, one range per stacked tensor: the
    reference's predicate (ROADMAP queue C)."""
    _, cfg, jp, _ = _models("h2o-danube-1.8b")
    rng = np.random.default_rng(5)
    tree = jax.tree_util.tree_map(
        lambda a: rng.normal(size=a.shape).astype(np.float32), jp)
    want = jptq.ptq_simulate(jax.tree_util.tree_map(jnp.asarray, tree),
                             JQuantConfig.parse(spec))
    got = ptq.ptq_simulate(transformer.params_from_jax(tree, "cpu"),
                           QuantConfig.parse(spec))
    flat = dict(ptq.tree_tensors(got))
    jflat = {"/" + "/".join(k.key for k in path): np.asarray(v)
             for path, v in jax.tree_util.tree_flatten_with_path(want)[0]}
    assert flat.keys() == jflat.keys()
    for k, v in flat.items():
        np.testing.assert_array_equal(v.numpy(), jflat[k], err_msg=k)
    gain = "/layers/b0_attn_local/norm1/scale"
    assert not np.array_equal(jflat[gain], tree["layers"]["b0_attn_local"][
        "norm1"]["scale"])                          # the gains moved
    assert np.array_equal(jflat["/final_norm/scale"],
                          tree["final_norm"]["scale"])    # 1-D: kept


def _direct_decode(cfg, params, tokens, new_tokens):
    caches = transformer.init_caches(cfg, tokens.shape[0],
                                     tokens.shape[1] + new_tokens,
                                     device="cpu")
    tok, out = tokens[:, :1], []
    for pos in range(tokens.shape[1] + new_tokens - 1):
        logits, caches = transformer.decode_step(cfg, params, tok, caches, pos)
        nxt = torch.argmax(logits[:, -1], -1)
        tok = tokens[:, pos + 1:pos + 2] if pos + 1 < tokens.shape[1] \
            else nxt[:, None]
        if pos + 1 >= tokens.shape[1]:
            out.append(int(nxt[0]))
    return out


@pytest.mark.parametrize("flags", [[], ["--quant", "ptq_int8",
                                        "--int8-cache"]])
def test_serve_on_the_cpu_emits_the_direct_decode_tokens(capsys, flags):
    argv = ["--arch", "h2o-danube-1.8b", "--reduced", "--device", "cpu",
            "--batch", "2", "--prompt-len", "8", "--new-tokens", "6",
            "--seed", "3"] + flags
    counts = [c.value for c in (fake_quant.launches,
                                int8_cache_attention.launches,
                                flash_attention.launches)]
    assert serve.main(argv) == 0
    out = capsys.readouterr().out
    assert "tok/s on cpu" in out
    printed = [int(t) for t in re.search(r"first sequence: \[(.*)\]",
                                         out).group(1).split(",")]
    cfg = cfgs.get_reduced("h2o-danube-1.8b")
    if flags:
        cfg = dataclasses.replace(cfg, quant=dataclasses.replace(
            cfg.quant, int8_kv_cache=True))
    params = transformer.init_params(cfg, torch.Generator().manual_seed(3),
                                     "cpu")
    if flags:
        params = ptq.ptq_simulate(params, QuantConfig.parse("ptq_int8"))
    tokens = torch.randint(0, cfg.vocab, (2, 8),
                           generator=torch.Generator().manual_seed(3))
    assert printed == _direct_decode(cfg, params, tokens, 6)
    assert [c.value for c in (fake_quant.launches,
                              int8_cache_attention.launches,
                              flash_attention.launches)] == counts
