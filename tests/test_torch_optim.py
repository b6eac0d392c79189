"""Port parity: the LM trainer's optimizers, schedules, mixed precision and
synthetic data against the JAX package, on the same numpy inputs.

Held:

* ``SyntheticLMDataset`` batches bitwise (numpy alone in both packages);
  ``make_lm_batch`` to shape, dtype and range (it draws from a
  ``torch.Generator`` where the reference draws from ``jax.random``);
* ``block_quantize`` codes and scales and ``block_dequantize`` bitwise,
  at block-aligned and ragged last axes, 1-D and 0-d tensors, all-zero
  blocks and exact half-way codes;
* ``adam_update``, float32 and 8-bit moments, with and without weight
  decay and an lr schedule, params and moments within 1e-6 over three
  steps (8-bit codes equal, scales within 1e-6);
* ``sgd_update`` plain, with momentum and Nesterov, within 1e-6; every
  schedule at a sweep of steps within 1e-6;
* ``core.mixed_precision``: the casts, the loss scale's transitions
  (halve on a non-finite step, grow after the interval, the floor),
  ``all_finite`` and ``select_tree``, bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mixed_precision as jmp
from repro.core.qconfig import MixedPrecisionConfig as JMP
from repro.data import synthetic as jsyn
from repro.optim import adam as jadam
from repro.optim import schedule as jsched
from repro.optim import sgd as jsgd
from repro_torch.core import mixed_precision as mp
from repro_torch.core.qconfig import MixedPrecisionConfig
from repro_torch.data import SyntheticLMDataset, make_lm_batch
from repro_torch.optim import adam, schedule, sgd

SHAPES = {"embed": {"w": (40, 16)}, "layers": {"w": (2, 16, 512),
                                                "scale": (2, 16)},
          "head": {"b": (7,)}}


def _tree(rng, scale=1.0):
    return {k: {n: (rng.normal(size=s) * scale).astype(np.float32)
                for n, s in v.items()} for k, v in SHAPES.items()}


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _leaves(tree):
    for k in sorted(tree):
        for n in sorted(tree[k]):
            yield (k, n), tree[k][n]


# ---------------------------------------------------------------------------
# synthetic data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,vocab,seq,batch", [(0, 512, 128, 8),
                                                  (3, 32000, 64, 2),
                                                  (7, 50, 1, 3)])
def test_synthetic_batches_are_the_references_bitwise(seed, vocab, seq,
                                                      batch):
    got = SyntheticLMDataset(vocab=vocab, seq_len=seq, batch=batch,
                             seed=seed)
    want = jsyn.SyntheticLMDataset(vocab=vocab, seq_len=seq, batch=batch,
                                   seed=seed)
    np.testing.assert_array_equal(got._succ, want._succ)
    for a, b, _ in zip(got.batches(), want.batches(), range(3)):
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(a["tokens"][:, 1:],
                                      a["labels"][:, :-1])


def test_make_lm_batch_shape_dtype_range():
    gen = torch.Generator().manual_seed(0)
    b = make_lm_batch(gen, 97, 3, 40)
    want = jsyn.make_lm_batch(jax.random.PRNGKey(0), 97, 3, 40)
    for k in ("tokens", "labels"):
        assert tuple(b[k].shape) == tuple(want[k].shape) == (3, 40)
        assert int(b[k].min()) >= 0 and int(b[k].max()) < 97
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])


# ---------------------------------------------------------------------------
# block quantization
# ---------------------------------------------------------------------------

def _block_cases():
    rng = np.random.default_rng(0)
    half = np.full((2, 256), 0.5, np.float32)
    half[:, 0] = 127.0                  # scale 1: codes at exact .5 ties
    half[1, 1:] = np.arange(255) - 127.5
    zero = rng.normal(size=(3, 512)).astype(np.float32)
    zero[1, 256:] = 0.0                 # an all-zero block
    return [("aligned", rng.normal(size=(4, 1024)).astype(np.float32)),
            ("ragged", rng.normal(size=(5, 300)).astype(np.float32) * 1e3),
            ("vector", rng.normal(size=(768,)).astype(np.float32)),
            ("scalar", np.float32(-2.5).reshape(())),
            ("stacked", rng.normal(size=(2, 3, 256)).astype(np.float32)),
            ("ties", half), ("zero block", zero),
            ("tiny", (rng.normal(size=(2, 256)) * 1e-30).astype(np.float32))]


@pytest.mark.parametrize("label,x", _block_cases(),
                         ids=[c[0] for c in _block_cases()])
def test_block_quantize_bitwise(label, x):
    got = adam.block_quantize(torch.from_numpy(np.array(x)))
    want = jadam.block_quantize(jnp.asarray(x))
    assert got.shape == tuple(want.shape)
    assert got.codes.dtype == torch.int8
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    np.testing.assert_array_equal(got.scales.numpy(),
                                  np.asarray(want.scales))
    np.testing.assert_array_equal(adam.block_dequantize(got).numpy(),
                                  np.asarray(jadam.block_dequantize(want)))


# ---------------------------------------------------------------------------
# Adam, SGD, schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("eightbit", [False, True], ids=["f32", "8bit"])
@pytest.mark.parametrize("extras", ["plain", "wd+schedule"])
def test_adam_update_matches_jax(eightbit, extras):
    rng = np.random.default_rng(1)
    kw = dict(lr=1e-2, eightbit=eightbit)
    jkw = dict(kw)
    if extras != "plain":
        kw.update(weight_decay=0.1, schedule=schedule.warmup_cosine(2, 6))
        jkw.update(weight_decay=0.1, schedule=jsched.warmup_cosine(2, 6))
    cfg, jcfg = adam.AdamConfig(**kw), jadam.AdamConfig(**jkw)
    params = _tree(rng, 0.3)
    p, jp = _torch(params), _jax(params)
    st, jst = adam.adam_init(p, cfg), jadam.adam_init(jp, jcfg)
    for _ in range(3):
        grads = _tree(rng, 2.0)
        p, st, stats = adam.adam_update(_torch(grads), st, p, cfg)
        jp, jst, jstats = jadam.adam_update(_jax(grads), jst, jp, jcfg)
        np.testing.assert_allclose(float(stats["grad_norm"]),
                                   float(jstats["grad_norm"]), rtol=1e-6)
        for (k, n), x in _leaves(p):
            np.testing.assert_allclose(x.numpy(), np.asarray(jp[k][n]),
                                       rtol=1e-6, atol=1e-6)
            for got, want in ((st.m[k][n], jst.m[k][n]),
                              (st.v[k][n], jst.v[k][n])):
                if eightbit:
                    np.testing.assert_array_equal(got.codes.numpy(),
                                                  np.asarray(want.codes))
                    np.testing.assert_allclose(got.scales.numpy(),
                                               np.asarray(want.scales),
                                               rtol=1e-6, atol=0)
                else:
                    np.testing.assert_allclose(got.numpy(),
                                               np.asarray(want), rtol=1e-6,
                                               atol=1e-6)
    assert int(st.step) == int(jst.step) == 3


def test_eightbit_moments_are_about_four_times_smaller():
    p = _torch(_tree(np.random.default_rng(2)))
    f32 = adam.moment_bytes(adam.adam_init(p, adam.AdamConfig()))
    q8 = adam.moment_bytes(adam.adam_init(p, adam.AdamConfig(
        eightbit=True)))
    n = sum(x.numel() for _, x in _leaves(p))
    assert f32 == 8 * n
    assert 3.0 < f32 / q8 <= 4.0


@pytest.mark.parametrize("momentum,nesterov", [(0.0, False), (0.9, False),
                                               (0.9, True)])
def test_sgd_update_matches_jax(momentum, nesterov):
    rng = np.random.default_rng(3)
    cfg = sgd.SGDConfig(lr=0.05, momentum=momentum, nesterov=nesterov)
    jcfg = jsgd.SGDConfig(lr=0.05, momentum=momentum, nesterov=nesterov)
    params = _tree(rng)
    p, jp = _torch(params), _jax(params)
    st, jst = sgd.sgd_init(p, cfg), jsgd.sgd_init(jp, jcfg)
    assert (st.velocity is None) == (jst.velocity is None)
    for _ in range(3):
        grads = _tree(rng)
        p, st = sgd.sgd_update(_torch(grads), st, p, cfg)
        jp, jst = jsgd.sgd_update(_jax(grads), jst, jp, jcfg)
        for (k, n), x in _leaves(p):
            np.testing.assert_allclose(x.numpy(), np.asarray(jp[k][n]),
                                       rtol=1e-6, atol=1e-6)
    assert int(st.step) == int(jst.step) == 3


@pytest.mark.parametrize("name,args", [
    ("constant", ()), ("linear_warmup", (10,)),
    ("warmup_cosine", (10, 100)), ("warmup_cosine", (0, 50, 0.0)),
    ("linear_epsilon", (1.0, 0.05, 40))])
def test_schedules_match_jax(name, args):
    fn, jfn = getattr(schedule, name)(*args), getattr(jsched, name)(*args)
    for s in (0, 1, 5, 10, 11, 49, 50, 99, 100, 1000):
        got = fn(torch.tensor(s, dtype=torch.int32))
        want = jfn(jnp.asarray(s, jnp.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   atol=1e-7)


# ---------------------------------------------------------------------------
# mixed precision
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["bf16", "fp16", "fp32"])
def test_to_compute_casts_floating_leaves(which):
    params = _tree(np.random.default_rng(4))
    params["embed"]["ids"] = np.arange(5, dtype=np.int32)
    got = mp.to_compute(_torch(params), getattr(MixedPrecisionConfig,
                                                which)())
    want = jmp.to_compute(_jax(params), getattr(JMP, which)())
    for (k, n), x in _leaves(got):
        w = want[k][n]
        assert str(x.dtype).split(".")[-1] == str(w.dtype)
        np.testing.assert_array_equal(x.to(torch.float32).numpy(),
                                      np.asarray(w, np.float32))


def test_cast_and_loss_scale_roundtrip():
    half = mp.to_compute({"w": torch.ones(3)}, MixedPrecisionConfig.bf16())
    assert half["w"].dtype == torch.bfloat16
    ls = mp.DynamicLossScale.init(1024.0)
    assert float(mp.scale_loss(torch.tensor(0.5), ls)) == 512.0
    assert mp.scale_loss(torch.tensor(0.5), None) == 0.5
    g = mp.unscale_grads({"g": torch.tensor([2048.0]),
                          "h": torch.tensor([6.0], dtype=torch.bfloat16)},
                         ls)
    assert g["g"].tolist() == [2.0] and g["h"].dtype == torch.bfloat16
    jg = jmp.unscale_grads({"h": jnp.asarray([6.0], jnp.bfloat16)},
                           jmp.DynamicLossScale.init(1024.0))
    assert float(g["h"][0]) == float(jg["h"][0])


@pytest.mark.parametrize("finite", [[False, True, True, True],
                                    [True, True, True, False, False],
                                    [False] * 12])
@pytest.mark.parametrize("interval", [1, 2, 2000])
def test_loss_scale_transitions_match_jax(finite, interval):
    ls = mp.DynamicLossScale.init(1024.0)
    jls = jmp.DynamicLossScale.init(1024.0)
    for ok in finite:
        ls = mp.update_loss_scale(ls, torch.tensor(ok),
                                  growth_interval=interval)
        jls = jmp.update_loss_scale(jls, jnp.asarray(ok),
                                    growth_interval=interval)
        assert float(ls.scale) == float(jls.scale)
        assert int(ls.good_steps) == int(jls.good_steps)
        assert ls.scale.dtype == torch.float32
        assert ls.good_steps.dtype == torch.int32
    if finite == [False] * 12:
        assert float(ls.scale) == 1.0      # the floor


def test_all_finite_and_select_tree():
    assert bool(mp.all_finite({"a": torch.ones(3),
                               "i": torch.zeros(2, dtype=torch.int32)}))
    assert not bool(mp.all_finite({"a": torch.tensor([1.0, float("nan")])}))
    assert not bool(mp.all_finite({"a": torch.tensor([float("inf")])}))
    assert bool(mp.all_finite({}))
    a, b = {"x": torch.ones(2)}, {"x": torch.zeros(2)}
    assert mp.select_tree(torch.tensor(True), a, b)["x"].tolist() == [1, 1]
    assert mp.select_tree(torch.tensor(False), a, b)["x"].tolist() == [0, 0]
