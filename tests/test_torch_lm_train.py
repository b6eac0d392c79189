"""Port parity: LM training (``--mode lm``) against the JAX package on the
CPU, at the reduced configs.

The same params and batches go through both packages
(``tests/torch_lm_parity.py``).  Held:

* ``loss_fn`` for h2o-danube-1.8b: the loss within 1e-5 relative and
  every gradient leaf within 1e-4 of its largest magnitude in float32
  compute (the port with remat on, through ``torch.utils.checkpoint``),
  and the loss within 2e-3 relative under the config's own ``mp``
  (bfloat16 compute); the other six configs are held the same way in
  ``test_torch_lm_loss.py`` and ``test_torch_lm_loss_recurrent.py``;
* ``qat_site_names`` equal to the reference's for all seven configs (and
  mixtral with ``quantize_router``), and the QAT collection after each
  of two ``make_train_step`` steps (one monitoring, one quantizing, each
  from the same state in both) within 1e-5, the losses within 1e-5
  relative;
* a remat step and a step without remat bitwise equal (loss, params,
  moments, collection), with the QAT sites and the attention layers
  counted: twice a step under remat, once without;
* ``grad_accum`` 2 against one batch of twice the size;
* ``ops.FlashAttentionDenseGrad``'s output and gradient against
  ``jax.vjp`` of the reference's ``dense_attention`` within 1e-5, with
  windows, soft-caps and groups, and its dtypes under bfloat16;
* the reference's smoke tests (``tests/test_arch_smoke.py:51-103``) on
  the port: an SGD step lowers the loss, a QAT forward keeps the site
  set; and ``launch.train --mode lm`` on the CPU, with checkpoints.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_lm_parity as lp
from repro.core.qconfig import QuantConfig as JQuantConfig
from repro.models import attention as jattn
from repro.models import transformer as jtr
from repro_torch.configs import base as cfgs
from repro_torch.core import mixed_precision as mp
from repro_torch.core import ptq
from repro_torch.core.qconfig import QuantConfig
from repro_torch.kernels import ops
from repro_torch.launch import steps
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer
from repro_torch.optim import adam

HERE = ["h2o-danube-1.8b"]


@pytest.mark.parametrize("name", HERE)
def test_loss_and_grads_match_jax_fp32(name):
    jcfg, cfg = lp.configs(name)
    assert cfg.remat
    tp, jp = lp.params(name)
    b = lp.batch(cfg.vocab)
    jl, jm, jg = lp.jax_value_and_grad(jcfg, jp, b)
    loss, metrics, grads = lp.torch_value_and_grad(cfg, tp, b)
    assert abs(float(loss) - float(jl)) <= lp.LOSS_RTOL * abs(float(jl))
    np.testing.assert_allclose(float(metrics["ce_loss"]),
                               float(jm["ce_loss"]), rtol=lp.LOSS_RTOL)
    lp.assert_grads_close(grads, jg)


@pytest.mark.parametrize("name", HERE)
def test_loss_matches_jax_under_own_mp(name):
    jcfg, cfg = lp.configs(name, fp32=False)
    assert cfg.mp.compute_dtype == "bfloat16"
    tp, jp = lp.params(name)
    b = lp.batch(cfg.vocab)
    jl = lp.jax_loss_own_mp(jcfg, jp, b)
    loss = lp.torch_loss_own_mp(cfg, tp, b)
    assert loss.dtype == torch.float32
    assert abs(float(loss) - float(jl)) <= lp.BF16_LOSS_RTOL * float(jl)


# ---------------------------------------------------------------------------
# QAT observers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,router", [(n, False) for n in lp.CONFIGS]
                         + [("mixtral-8x7b", True)])
def test_qat_site_names_match_jax(name, router):
    q = QuantConfig.qat(8)
    jq = JQuantConfig.qat(8)
    q = dataclasses.replace(q, quantize_router=router)
    jq = dataclasses.replace(jq, quantize_router=router)
    jcfg, cfg = lp.configs(name, quant=q, jquant=jq)
    inside, outside = transformer.qat_site_names(cfg)
    jin, jout = jtr.qat_site_names(jcfg)
    assert (inside, outside) == (set(jin), set(jout))
    assert all(n.startswith("unit/") for n in inside)
    coll = transformer.init_qat_collection(cfg, "cpu")
    assert list(coll) == sorted(jtr.init_qat_collection(jcfg))
    assert all(not bool(s.initialized) for s in coll.values())


def _collections_close(coll, jcoll):
    assert sorted(coll) == sorted(jcoll)
    for k, st in coll.items():
        js = jcoll[k]
        assert bool(st.initialized) == bool(js.initialized), k
        for f in ("vmin", "vmax"):
            np.testing.assert_allclose(float(getattr(st, f)),
                                       float(getattr(js, f)), rtol=1e-5,
                                       atol=1e-5, err_msg=k)


def _jax_collection(coll):
    from repro.core.fake_quant import ObserverState
    return {k: ObserverState(*(jnp.asarray(t.numpy()) for t in st))
            for k, st in coll.items()}


def test_qat_collection_after_train_steps_matches_jax():
    """Two ``make_train_step`` steps at ``quant_delay`` 1: the first
    monitors (the observers move), the second quantizes (they freeze).
    Each step starts both packages from the port's state before it; the
    reference's collection is what its ``train_step`` returns, the
    metrics of ``loss_fn``."""
    jcfg, cfg = lp.configs("h2o-danube-1.8b",
                           quant=QuantConfig.qat(8, quant_delay=1),
                           jquant=JQuantConfig.qat(8, quant_delay=1))
    tp, _ = lp.params("h2o-danube-1.8b")
    tstep, adam_cfg = steps.make_train_step(cfg)
    opt = adam.adam_init(tp, adam_cfg)
    q = transformer.init_qat_collection(cfg, "cpu")
    jloss = None
    for i in range(2):
        b = lp.batch(cfg.vocab, seed=10 + i)
        args = (lp.to_jax(tp), lp.jax_batch(b), _jax_collection(q),
                jnp.asarray(i, jnp.int32))
        jloss = jloss or lp.compiled(lambda p, b, c, s: jtr.loss_fn(
            jcfg, p, b, qat_collection=c, step=s), *args)
        jl, jm = jloss(*args)
        before = q
        tp, opt, q, m = tstep(tp, opt, lp.torch_batch(b), q)
        np.testing.assert_allclose(float(m["loss"]), float(jl),
                                   rtol=lp.LOSS_RTOL)
        _collections_close(q, jm["qat_collection"])
        assert all(bool(s.initialized) for s in q.values())
    for k, st in q.items():                  # frozen from the delay on
        assert all(torch.equal(a, b) for a, b in zip(st, before[k])), k


def _count(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def counted(*a, **k):
        calls.append(1)
        return fn(*a, **k)
    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("name", ["h2o-danube-1.8b", "mixtral-8x7b"])
def test_remat_step_is_bitwise_the_plain_step(monkeypatch, name):
    """One QAT train step with and without activation checkpointing:
    bitwise equal results; under remat every site and attention layer of
    the stacked units runs twice (forward and recompute), and the head's
    weight site twice a loss chunk either way."""
    q = QuantConfig.qat(8, quant_delay=1)
    runs = {}
    for remat in (True, False):
        _, cfg = lp.configs(name, quant=q, remat=remat)
        tp, _ = lp.params(name)
        step, adam_cfg = steps.make_train_step(cfg)
        coll = transformer.init_qat_collection(cfg, "cpu")
        act = _count(monkeypatch, ops, "qat_activation_site")
        wt = _count(monkeypatch, ops, "qat_weight_site")
        fa = _count(monkeypatch, ops, "flash_attention")
        out = step(tp, adam.adam_init(tp, adam_cfg),
                   lp.torch_batch(lp.batch(cfg.vocab)), coll)
        runs[remat] = (out, len(act), len(wt), len(fa))
        monkeypatch.undo()
    (a, n_act, n_wt, n_fa), (b, p_act, p_wt, p_fa) = runs[True], runs[False]
    assert float(a[3]["loss"]) == float(b[3]["loss"])
    for (ka, x), (kb, y) in zip(ptq.tree_tensors(a[:3]),
                                ptq.tree_tensors(b[:3])):
        assert ka == kb and torch.equal(x, y), ka
    layers = cfg.n_layers
    unit_act = len(transformer.qat_site_names(cfg)[0]) * layers
    unit_wt = 7 * layers                 # q, k, v, o and the MLP / experts
    assert (p_act, p_wt, p_fa) == (unit_act + 1, unit_wt + 2, layers)
    assert (n_act, n_wt, n_fa) == (2 * unit_act + 1, 2 * unit_wt + 2,
                                   2 * layers)


def test_grad_accum_two_is_one_batch_of_twice_the_size():
    _, one = lp.configs("h2o-danube-1.8b")
    two = dataclasses.replace(one, grad_accum=2)
    b = lp.torch_batch(lp.batch(one.vocab, b=4))
    out = {}
    for cfg in (one, two):
        tp, _ = lp.params("h2o-danube-1.8b")
        step, adam_cfg = steps.make_train_step(cfg)
        out[cfg.grad_accum] = step(tp, adam.adam_init(tp, adam_cfg), b, {})
    (p1, o1, _, m1), (p2, o2, _, m2) = out[1], out[2]
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(m2["grad_norm"]),
                               float(m1["grad_norm"]), rtol=1e-5)
    for (k, x), (_, y) in zip(ptq.tree_tensors(o1.m),
                              ptq.tree_tensors(o2.m)):
        scale = float(x.abs().max())
        assert float((x - y).abs().max()) <= 1e-5 * max(scale, 1e-12), k
    for (k, x), (_, y) in zip(ptq.tree_tensors(p1), ptq.tree_tensors(p2)):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# B4 under autograd
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv,g,s,window,softcap", [
    (2, 3, 24, None, None), (2, 4, 40, 8, None), (1, 4, 33, None, 30.0),
    (3, 1, 17, 5, 4.0), (2, 2, 64, 64, 50.0)])
def test_attention_grad_matches_jax_dense_attention(kv, g, s, window,
                                                    softcap):
    rng = np.random.default_rng(s + kv + g)
    b, d = 2, 16
    q = rng.normal(size=(b, s, kv * g, d)).astype(np.float32)
    k = (rng.normal(size=(b, s, kv, d)) * 1.5).astype(np.float32)
    v = rng.normal(size=(b, s, kv, d)).astype(np.float32)
    ct = rng.normal(size=(b, s, kv * g, d)).astype(np.float32)

    def ref(q, k, v):
        out = jattn.dense_attention(q.reshape(b, s, kv, g, d), k, v,
                                    causal=True, window=window,
                                    softcap=softcap)
        return out.reshape(b, s, kv * g, d)
    def out_and_grads(q, k, v, ct):
        out, vjp = jax.vjp(ref, q, k, v)
        return (out,) + vjp(ct)
    args = tuple(jnp.asarray(x) for x in (q, k, v, ct))
    jout, jdq, jdk, jdv = lp.compiled(out_and_grads, *args)(*args)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    out = ops.FlashAttentionDenseGrad.apply(tq, tk, tv, True, window,
                                            softcap, d ** -0.5)
    dq, dk, dv = torch.autograd.grad(out, (tq, tk, tv),
                                     torch.from_numpy(ct))
    for got, want in ((out, jout), (dq, jdq), (dk, jdk), (dv, jdv)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def test_attention_function_dtypes_under_bf16():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(1, 8, 4, 16)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(1, 8, 2, 16)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(1, 8, 2, 16)).astype(np.float32))
    ins = [x.to(torch.bfloat16).requires_grad_(True) for x in (q, k, v)]
    out = ops.FlashAttentionDenseGrad.apply(*ins, True, None, None, 0.25)
    assert out.dtype == torch.bfloat16
    want = ops.flash_attention(*(x.detach().float() for x in ins),
                               scale=0.25)
    assert torch.equal(out, want.to(torch.bfloat16))
    grads = torch.autograd.grad(out.float().sum(), ins)
    assert [x.dtype for x in grads] == [torch.bfloat16] * 3
    assert all(bool(torch.isfinite(x.float()).all()) for x in grads)


# ---------------------------------------------------------------------------
# the reference's smoke tests, on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", lp.CONFIGS)
def test_sgd_step_lowers_loss_and_qat_forward_keeps_sites(name):
    cfg = cfgs.get_reduced(name)
    tp, _ = lp.params(name)
    b = lp.torch_batch(lp.batch(cfg.vocab, seed=2))
    loss0, _, grads = steps.value_and_grad(cfg, tp, b, None,
                                           torch.tensor(0))
    assert bool(torch.isfinite(loss0))
    tp = ptq.tree_map(lambda p, g: p - 1e-2 * g, tp, grads)
    loss1, _, _ = steps.value_and_grad(cfg, tp, b, None, torch.tensor(0))
    assert float(loss1) <= float(loss0) + 1e-3, (name, loss0, loss1)
    qcfg = dataclasses.replace(cfg, quant=QuantConfig.qat(8, quant_delay=0))
    coll = transformer.init_qat_collection(qcfg, "cpu")
    loss, metrics = transformer.loss_fn(
        qcfg, mp.to_compute(tp, qcfg.mp), b, qat_collection=coll, step=0)
    assert bool(torch.isfinite(loss))
    assert set(metrics["qat_collection"]) == set(coll)


def test_launch_train_lm_on_cpu(tmp_path, capsys):
    argv = ["--mode", "lm", "--arch", "h2o-danube-1.8b", "--reduced",
            "--steps", "4", "--batch", "2", "--seq", "32", "--device", "cpu",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    assert launch_train.main(argv) == 0
    out = capsys.readouterr().out
    assert "[train/lm] h2o-danube-1.8b-reduced" in out
    assert "mp=bfloat16" in out and "8bit-adam=False" in out
    losses = [float(line.split("loss")[1].split()[0])
              for line in out.splitlines() if line.strip().startswith("step")]
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert "ckpt_00000003" in out
    assert launch_train.main(argv[:-4] + ["--ckpt-dir", str(tmp_path),
                                          "--resume"]) == 0
    assert "resumed params from step 3" in capsys.readouterr().out
    # the encoder configs are ported: whisper trains too
    assert launch_train.main(["--mode", "lm", "--arch", "whisper-tiny",
                              "--reduced", "--steps", "2", "--batch", "2",
                              "--seq", "16", "--device", "cpu"]) == 0
    assert "[train/lm] whisper-tiny-reduced" in capsys.readouterr().out
