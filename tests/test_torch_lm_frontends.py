"""Port parity: the encoder and cross-attention configs (whisper-tiny,
llama-3.2-vision-90b) and grok-1-314b through the LM inference path.

The same params (drawn by the JAX package, carried across with
``transformer.params_from_jax``), tokens and stub frontend embeddings
(``encoder_out``, seeded normals times 0.02 from numpy) go through both
packages on the CPU, at the reduced configs.  Held, at the tolerances of
``tests/test_torch_lm_families.py``:

* the configs field for field, the parameter specs (the encoder's
  stacked blocks, the ``cross`` blocks' second attention and norm), and
  the converted trees: float32 leaves bitwise, and a bfloat16 JAX tree
  (grok-1's ``param_dtype``) carried bit for bit in bfloat16;
* ``forward`` logits, and grok's load-balance loss, within 1e-4;
* 12 teacher-forced ``decode_step``s from zeroed float32 caches within
  1e-4, the encoder re-run at every step; with int8 caches every logit
  within ``FLIP_ATOL`` and at least ``TIGHT_SHARE`` within 1e-4 (a
  projection an ulp apart can move one K/V code, as
  ``tests/test_torch_lm.py`` holds it);
* the port's decode against its forward over 16 tokens within 2e-2, the
  reference's contract (``tests/test_arch_smoke.py:150-186``; these
  configs have no ring to wrap);
* a ``cross`` block given no ``encoder_out``: non-causal attention of x
  over itself without RoPE, as the reference's branches give;
* ``qat_site_names`` of llama-vision and grok equal to the reference's,
  and whisper's QAT forward raising where the reference's cannot run
  (its encoder observers leak out of ``lax.scan``);
* ``ptq_simulate`` of the three trees bitwise JAX's;
* ``launch.serve`` on the CPU for each config, with and without
  ``--int8-cache``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import base as jcfgs
from repro.core import ptq as jptq
from repro.core.qconfig import QuantConfig as JQuantConfig
from repro.models import blocks as jblocks
from repro.models import transformer as jtr
from repro_torch.configs import base as cfgs
from repro_torch.core import fake_quant, ptq
from repro_torch.core.qconfig import QuantConfig
from repro_torch.launch import serve
from repro_torch.models import blocks, transformer

NAMES = ["whisper-tiny", "llama-3.2-vision-90b", "grok-1-314b"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's many small ops: beside the
    other test workers on the same cores, more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
TOL = 1e-4
DECODE_ATOL = 2e-2
FLIP_ATOL = 5e-3
TIGHT_SHARE = 0.75


def _fields(c):
    out = dataclasses.asdict(c)
    out["quant"] = {k: getattr(v, "value", v) for k, v in out["quant"].items()}
    return out


@functools.lru_cache(maxsize=None)
def _models(name):
    jcfg, cfg = jcfgs.get_reduced(name), cfgs.get_reduced(name)
    jp = jax.jit(lambda key: jtr.init_params(jcfg, key))(
        jax.random.PRNGKey(0))
    tp = transformer.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                     "cpu")
    return jcfg, cfg, jp, tp


def _tokens(b, s, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _enc(cfg, b, seed):
    """The stub frontend's embeddings, or None for a config without."""
    if not (cfg.cross_attn or cfg.encoder_layers):
        return None
    shape = (b, max(cfg.encoder_seq, 4), cfg.d_model)
    return (np.random.default_rng(seed).normal(size=shape) * 0.02).astype(
        np.float32)


def _jnp(x):
    return None if x is None else jnp.asarray(x)


def _torch(x):
    return None if x is None else torch.from_numpy(x)


def _jflat(tree):
    return {"/" + "/".join(k.key for k in path): np.asarray(v) for path, v
            in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("name", NAMES)
def test_configs_are_the_references(name):
    for get in ("get", "get_reduced"):
        j, t = getattr(jcfgs, get)(name), getattr(cfgs, get)(name)
        assert _fields(t) == _fields(j)
        assert (t.hd, t.pattern_repeats, t.pattern_remainder) == \
            (j.hd, j.pattern_repeats, j.pattern_remainder)
        assert t.n_params() == j.n_params()
        assert t.n_active_params() == j.n_active_params()


def _spec_shapes(tree, leaf):
    if isinstance(tree, dict):
        return {k: _spec_shapes(v, leaf) for k, v in tree.items()}
    return leaf(tree)


@pytest.mark.parametrize("name", NAMES)
def test_param_specs_and_converted_trees_follow_the_reference(name):
    jcfg, cfg, jp, tp = _models(name)

    def shape_init(p):
        return tuple(p.shape), p.init
    jspec = jtr.param_specs(jcfg)
    assert _spec_shapes(transformer.param_specs(cfg), shape_init) == \
        jax.tree_util.tree_map(shape_init, jspec, is_leaf=lambda x:
                               isinstance(x, type(jspec["embed"]["w"])))
    flat, jflat = dict(ptq.tree_tensors(tp)), _jflat(jp)
    assert flat.keys() == jflat.keys()
    for k, v in flat.items():
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), jflat[k])
    if cfg.encoder_layers:
        assert tp["encoder"]["b0_attn"]["attn"]["q"]["w"].shape == \
            (cfg.encoder_layers, cfg.d_model, cfg.n_heads * cfg.hd)
        assert set(tp["encoder_norm"]) == {"scale", "bias"}
    if cfg.cross_attn:
        unit = tp["layers"][f"b{len(cfg.pattern) - 1}_cross"]
        assert {"cross", "norm_cross", "attn", "mlp"} <= set(unit)


def test_bfloat16_trees_cross_bit_for_bit():
    """grok-1's bfloat16 params: the reference's tree carried in bfloat16
    bit for bit, and the port's draw in bfloat16 the round-to-nearest-even
    of its float32 draw."""
    jcfg, cfg = jcfgs.get_reduced("grok-1-314b"), \
        cfgs.get_reduced("grok-1-314b")
    jp = jax.jit(lambda key: jtr.init_params(jcfg, key, jnp.bfloat16))(
        jax.random.PRNGKey(0))
    tp = transformer.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                     "cpu")
    jflat = _jflat(jp)
    for k, v in ptq.tree_tensors(tp):
        assert v.dtype == torch.bfloat16, k
        np.testing.assert_array_equal(v.view(torch.uint16).numpy(),
                                      jflat[k].view(np.uint16), err_msg=k)
    f32 = transformer.init_params(cfg, torch.Generator().manual_seed(3),
                                  "cpu")
    bf16 = transformer.init_params(cfg, torch.Generator().manual_seed(3),
                                   "cpu", dtype=torch.bfloat16)
    for (k, a), (_, b) in zip(ptq.tree_tensors(f32), ptq.tree_tensors(bf16)):
        assert b.dtype == torch.bfloat16
        want = a.numpy().astype(ml_dtypes.bfloat16).view(np.uint16)
        np.testing.assert_array_equal(b.view(torch.uint16).numpy(), want,
                                      err_msg=k)


@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_jax(name):
    jcfg, cfg, jp, tp = _models(name)
    toks, enc = _tokens(2, 16, cfg.vocab, seed=11), _enc(cfg, 2, seed=12)
    want, jaux, _ = jax.jit(lambda p, t, e: jtr.forward(
        jcfg, p, t, encoder_out=e))(jp, jnp.asarray(toks), _jnp(enc))
    got, aux, _ = transformer.forward(cfg, tp, torch.from_numpy(toks).long(),
                                      encoder_out=_torch(enc))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=TOL, atol=TOL)
    assert (float(aux) > 0) == (cfg.n_experts > 0)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_decode_episode_matches_jax(name, int8):
    jcfg, cfg, jp, tp = _models(name)
    toks, enc = _tokens(2, 12, cfg.vocab, seed=3), _enc(cfg, 2, seed=4)
    jc = jtr.init_caches(jcfg, 2, 12, int8=int8, dtype=jnp.float32)
    tc = transformer.init_caches(cfg, 2, 12, int8=int8, device="cpu")
    step = jax.jit(lambda p, t, c, pos, e: jtr.decode_step(
        jcfg, p, t, c, pos, encoder_out=e))
    diffs = []
    for pos in range(12):
        want, jc = step(jp, jnp.asarray(toks[:, pos:pos + 1]), jc,
                        jnp.asarray(pos), _jnp(enc))
        got, tc = transformer.decode_step(
            cfg, tp, torch.from_numpy(toks[:, pos:pos + 1]).long(), tc, pos,
            encoder_out=_torch(enc))
        diffs.append(np.abs(got.numpy() - np.asarray(want)))
    diffs = np.stack(diffs)
    if int8:
        assert diffs.max() <= FLIP_ATOL
        assert (diffs <= TOL).mean() >= TIGHT_SHARE
    else:
        assert diffs.max() <= TOL


@pytest.mark.parametrize("name", NAMES)
def test_decode_matches_forward(name):
    """16 tokens, the encoder re-run and the cross K/V re-projected at
    every step."""
    cfg = cfgs.get_reduced(name)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=4.0)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(4),
                                     "cpu")
    toks = torch.from_numpy(_tokens(1, 16, cfg.vocab, seed=4)).long()
    enc = _torch(_enc(cfg, 1, seed=5))
    full, _, _ = transformer.forward(cfg, params, toks, encoder_out=enc)
    caches = transformer.init_caches(cfg, 1, 16, device="cpu")
    for pos in range(16):
        logits, caches = transformer.decode_step(
            cfg, params, toks[:, pos:pos + 1], caches, pos, encoder_out=enc)
        torch.testing.assert_close(logits[0, 0], full[0, pos],
                                   rtol=DECODE_ATOL, atol=DECODE_ATOL)
    torch.testing.assert_close(
        transformer.prefill(cfg, params, toks, encoder_out=enc),
        full[:, -1:], rtol=1e-5, atol=1e-5)


def test_cross_block_without_encoder_out_matches_jax():
    """The reference's branches: with ``kv_source`` None, the cross
    attention is non-causal attention of x over itself, without RoPE."""
    jcfg, cfg, jp, tp = _models("llama-3.2-vision-90b")
    unit_j = jax.tree_util.tree_map(lambda a: a[0], jp["layers"])["b1_cross"]
    unit_t = transformer._layer(tp["layers"], 0)["b1_cross"]
    x = np.random.default_rng(6).normal(size=(2, 9, cfg.d_model)).astype(
        np.float32)
    want, _, _ = jax.jit(lambda p, x: jblocks.apply_block(
        "cross", jcfg, jtr._make_ctx(jcfg, {}, 0), p, x))(unit_j,
                                                          jnp.asarray(x))
    got, _, _ = blocks.apply_block("cross", cfg, fake_quant.NullQATContext(),
                                   unit_t, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    # ... which is not the causal self-attention block's output
    causal, _, _ = blocks.apply_block(
        "cross", cfg, fake_quant.NullQATContext(), unit_t,
        torch.from_numpy(x), encoder_out=torch.from_numpy(x))
    assert not torch.allclose(causal, got, atol=1e-3)


@pytest.mark.parametrize("name", ["llama-3.2-vision-90b", "grok-1-314b"])
def test_qat_site_names_match_jax(name):
    jcfg = dataclasses.replace(jcfgs.get_reduced(name),
                               quant=JQuantConfig.qat(8))
    cfg = dataclasses.replace(cfgs.get_reduced(name), quant=QuantConfig.qat(8))
    inside, outside = transformer.qat_site_names(cfg)
    jin, jout = jtr.qat_site_names(jcfg)
    assert (inside, outside) == (set(jin), set(jout))
    if cfg.cross_attn:
        assert "unit/b1/cross/q_out" in inside
    coll = transformer.init_qat_collection(cfg, "cpu")
    assert list(coll) == sorted(jtr.init_qat_collection(jcfg))


def test_whisper_qat_raises_where_the_reference_cannot_run():
    """The reference calls the encoder's sites inside ``lax.scan`` with
    the outer QAT context (``repro/models/transformer.py:203-220``), so
    their observers leak out of the scan: a jitted QAT forward raises.
    The port raises ``NotImplementedError`` naming ROADMAP queue C rather
    than invent what that forward would compute."""
    jcfg = dataclasses.replace(jcfgs.get_reduced("whisper-tiny"),
                               quant=JQuantConfig.qat(8))
    cfg = dataclasses.replace(cfgs.get_reduced("whisper-tiny"),
                              quant=QuantConfig.qat(8))
    _, _, jp, tp = _models("whisper-tiny")
    toks, enc = _tokens(1, 4, cfg.vocab, seed=7), _enc(cfg, 1, seed=8)
    jcoll = jtr.init_qat_collection(jcfg)
    assert "enc/attn/q_out" in jcoll
    with pytest.raises(jax.errors.UnexpectedTracerError):
        jax.jit(lambda p, t, e, c: jtr.forward(
            jcfg, p, t, encoder_out=e, qat_collection=c, step=5))(
                jp, jnp.asarray(toks), jnp.asarray(enc), jcoll)
    # the site names are found as the reference finds them ...
    inside, outside = transformer.qat_site_names(cfg)
    assert (inside, outside) == tuple(map(set, jtr.qat_site_names(jcfg)))
    coll = transformer.init_qat_collection(cfg, "cpu")
    # ... but the forward and a decode step raise
    with pytest.raises(NotImplementedError, match="queue C"):
        transformer.forward(cfg, tp, torch.from_numpy(toks).long(),
                            encoder_out=_torch(enc), qat_collection=coll,
                            step=5)
    caches = transformer.init_caches(cfg, 1, 4, device="cpu")
    with pytest.raises(NotImplementedError, match="leaked tracers"):
        transformer.decode_step(cfg, tp, torch.from_numpy(toks[:, :1]).long(),
                                caches, 0, encoder_out=_torch(enc))


@pytest.mark.parametrize("name", NAMES)
def test_ptq_simulate_on_the_tree_is_bitwise_jax(name):
    """The reference's quirks kept: stacked norm gains (2-D) quantized
    per tensor with one range, grok's 4-D stacked experts per output
    column (plain torch)."""
    _, _, jp, tp = _models(name)
    want = _jflat(jax.jit(lambda p: jptq.ptq_simulate(
        p, JQuantConfig.parse("ptq_int8")))(jp))
    got = ptq.ptq_simulate(tp, QuantConfig.parse("ptq_int8"))
    for k, v in ptq.tree_tensors(got):
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_serve_runs_each_config_on_the_cpu(capsys, name, int8):
    argv = ["--arch", name, "--reduced", "--device", "cpu", "--batch", "2",
            "--prompt-len", "6", "--new-tokens", "4"]
    assert serve.main(argv + (["--int8-cache"] if int8 else [])) == 0
    out = capsys.readouterr().out
    assert f"int8_cache={int8}" in out and "tok/s on cpu" in out
