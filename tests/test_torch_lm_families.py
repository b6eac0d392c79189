"""Port parity: the MoE, recurrent and the two further dense LM configs
(recurrentgemma-2b, xlstm-125m, mixtral-8x7b, codeqwen1.5-7b,
stablelm-12b) through the LM inference path.

The same params (drawn by the JAX package, carried across with
``transformer.params_from_jax``) and the same tokens go through both
packages on the CPU, at the reduced configs; recurrentgemma's runs five
layers, ``(rglru, rglru, attn_local)`` and an ``(rglru, rglru)``
remainder, as the full config is built.  Held:

* the configs field for field, the parameter specs (shapes and
  initializers), and the converted trees' shapes;
* ``forward`` logits, and mixtral's load-balance loss, within rtol = atol
  = 1e-4 (measured up to 3.6e-6 on logits up to 4.4);
* 12 teacher-forced ``decode_step``s from zeroed caches within 1e-4 at
  every step (measured up to 3.6e-6);
* the port's own decode against its forward over 40 tokens (the local
  layers' 32-slot rings wrap) within 2e-2, the reference's contract
  (``tests/test_arch_smoke.py:150-186``), MoE at ``capacity_factor`` 4
  as there;
* ``ptq_simulate`` on a MoE block's leaves at mixtral's layout bitwise
  JAX's: the stacked expert weights are 4-D, so both packages take them
  per output channel as if they were conv kernels (plain torch, not
  kernel B5);
* ``launch.serve`` on the CPU for each config, with and without
  ``--int8-cache``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcfgs
from repro.core import ptq as jptq
from repro.core.qconfig import QuantConfig as JQuantConfig
from repro.models import transformer as jtr
from repro_torch.configs import base as cfgs
from repro_torch.core import ptq
from repro_torch.core.qconfig import QuantConfig
from repro_torch.launch import serve
from repro_torch.models import transformer

FAMILIES = ["recurrentgemma-2b", "xlstm-125m", "mixtral-8x7b",
            "codeqwen1.5-7b", "stablelm-12b"]
TOL = 1e-4
DECODE_ATOL = 2e-2


def _fields(c):
    out = dataclasses.asdict(c)
    out["quant"] = {k: getattr(v, "value", v) for k, v in out["quant"].items()}
    return out


def _cfg(pkg, name):
    cfg = pkg.get_reduced(name)
    if name == "recurrentgemma-2b":
        cfg = dataclasses.replace(cfg, n_layers=5,
                                  pattern=(pkg.RGLRU, pkg.RGLRU,
                                           pkg.ATTN_LOCAL))
    return cfg


@functools.lru_cache(maxsize=None)
def _models(name):
    jcfg, cfg = _cfg(jcfgs, name), _cfg(cfgs, name)
    jp = jax.jit(lambda key: jtr.init_params(jcfg, key))(
        jax.random.PRNGKey(0))
    tp = transformer.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                     "cpu")
    return jcfg, cfg, jp, tp


def _tokens(b, s, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("name", FAMILIES)
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


@pytest.mark.parametrize("name", FAMILIES)
def test_param_specs_and_converted_trees_follow_the_reference(name):
    jcfg, cfg, jp, tp = _models(name)

    def shape_init(p):
        return tuple(p.shape), p.init
    jspec = jtr.param_specs(jcfg)
    assert _spec_shapes(transformer.param_specs(cfg), shape_init) == \
        jax.tree_util.tree_map(shape_init, jspec, is_leaf=lambda x:
                               isinstance(x, type(jspec["embed"]["w"])))
    flat = dict(ptq.tree_tensors(tp))
    jflat = {"/" + "/".join(k.key for k in path): v for path, v in
             jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert flat.keys() == jflat.keys()
    for k, v in flat.items():
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), np.asarray(jflat[k]))
    if name == "mixtral-8x7b":
        e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
        moe = tp["layers"]["b0_moe_local"]["moe"]
        assert moe["wi"]["w"].shape == (2, e, d, f)
        assert moe["wo"]["w"].shape == (2, e, f, d)
    if name == "recurrentgemma-2b":
        rg = tp["layers"]["b0_rglru"]["rglru"]
        assert rg["conv"]["w"].shape == (1, 4, cfg.d_model)
        assert rg["log_lambda"].shape == (1, cfg.d_model)
        assert set(tp["remainder"]) == {"r0_rglru", "r1_rglru"}
        assert tp["remainder"]["r1_rglru"]["rglru"]["conv"]["w"].shape == \
            (4, cfg.d_model)


@pytest.mark.parametrize("name", FAMILIES)
def test_forward_matches_jax(name):
    jcfg, cfg, jp, tp = _models(name)
    toks = _tokens(2, 16, cfg.vocab, seed=11)
    want, jaux, _ = jax.jit(lambda p, t: jtr.forward(jcfg, p, t))(
        jp, jnp.asarray(toks))
    got, aux, _ = transformer.forward(cfg, tp,
                                      torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=TOL, atol=TOL)
    assert (float(aux) > 0) == (cfg.n_experts > 0)


@pytest.mark.parametrize("name", FAMILIES)
def test_decode_episode_matches_jax(name):
    jcfg, cfg, jp, tp = _models(name)
    toks = _tokens(2, 12, cfg.vocab, seed=3)
    jc = jtr.init_caches(jcfg, 2, 12, dtype=jnp.float32)
    tc = transformer.init_caches(cfg, 2, 12, device="cpu")
    step = jax.jit(lambda p, t, c, pos: jtr.decode_step(jcfg, p, t, c, pos))
    for pos in range(12):
        want, jc = step(jp, jnp.asarray(toks[:, pos:pos + 1]), jc,
                        jnp.asarray(pos))
        got, tc = transformer.decode_step(
            cfg, tp, torch.from_numpy(toks[:, pos:pos + 1]).long(), tc, pos)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL, err_msg=f"step {pos}")
    # the recurrent states advanced in place, as the reference's did
    jflat = jax.tree_util.tree_leaves(jc)
    tflat = [x for x in _state_leaves(tc)]
    assert len(jflat) == len(tflat)
    for j, t in zip(jflat, tflat):
        np.testing.assert_allclose(t.numpy().astype(np.float32),
                                   np.asarray(j).astype(np.float32),
                                   rtol=TOL, atol=TOL)


def _state_leaves(caches):
    """The port's cache leaves in the order ``jax.tree_util`` flattens the
    reference's (dict keys sorted, a KVCache's fields in order)."""
    def walk(x):
        if isinstance(x, dict):
            for k in sorted(x):
                yield from walk(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                if v is not None:
                    yield from walk(v)
        else:
            yield x
    return list(walk(caches))


@pytest.mark.parametrize("name", FAMILIES)
def test_decode_matches_forward(name):
    """40 tokens: the local layers' 32-slot rings wrap; the recurrent
    states carry every step."""
    cfg = _cfg(cfgs, name)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=4.0)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(4),
                                     "cpu")
    toks = torch.from_numpy(_tokens(1, 40, cfg.vocab, seed=4)).long()
    full, _, _ = transformer.forward(cfg, params, toks)
    caches = transformer.init_caches(cfg, 1, 40, device="cpu")
    for pos in range(40):
        logits, caches = transformer.decode_step(cfg, params,
                                                 toks[:, pos:pos + 1],
                                                 caches, pos)
        torch.testing.assert_close(logits[0, 0], full[0, pos],
                                   rtol=DECODE_ATOL, atol=DECODE_ATOL)
    torch.testing.assert_close(transformer.prefill(cfg, params, toks),
                               full[:, -1:], rtol=1e-5, atol=1e-5)


def test_ptq_simulate_on_the_moe_tree_is_bitwise_jax():
    """A MoE block's leaves at mixtral's layout: the stacked router (3-D,
    per tensor through B5's plain version) and expert weights (4-D, per
    output channel)."""
    rng = np.random.default_rng(5)
    tree = {"router": {"w": rng.normal(size=(2, 16, 4))},
            "wi": {"w": rng.normal(size=(2, 4, 16, 24))},
            "wo": {"w": rng.normal(size=(2, 4, 24, 16))}}
    tree = jax.tree_util.tree_map(lambda a: a.astype(np.float32), tree)
    want = jptq.ptq_simulate(jax.tree_util.tree_map(jnp.asarray, tree),
                             JQuantConfig.parse("ptq_int8"))
    got = ptq.ptq_simulate(transformer.params_from_jax(tree, "cpu"),
                           QuantConfig.parse("ptq_int8"))
    jflat = {"/" + "/".join(k.key for k in path): np.asarray(v)
             for path, v in jax.tree_util.tree_flatten_with_path(want)[0]}
    for k, v in ptq.tree_tensors(got):
        np.testing.assert_array_equal(v.numpy(), jflat[k], err_msg=k)
    per_channel = got["wi"]["w"].amax(dim=(0, 1, 2))
    assert len(set(per_channel.tolist())) > 1       # not one range


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("name", FAMILIES)
def test_serve_runs_each_family_on_the_cpu(capsys, name, int8):
    argv = ["--arch", name, "--reduced", "--device", "cpu", "--batch", "2",
            "--prompt-len", "6", "--new-tokens", "4"]
    assert serve.main(argv + (["--int8-cache"] if int8 else [])) == 0
    out = capsys.readouterr().out
    assert f"int8_cache={int8}" in out and "tok/s on cpu" in out
