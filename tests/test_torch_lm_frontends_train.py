"""Port parity: LM training (``--mode lm``) of the encoder and
cross-attention configs (whisper-tiny, llama-3.2-vision-90b) and of
grok-1-314b with bfloat16 parameters, against the JAX package on the
CPU, at the reduced configs.

The same params, batches and stub ``encoder_out`` go through both
packages (``tests/torch_lm_parity.py``).  Held:

* ``loss_fn`` in float32 compute: the loss within ``LOSS_RTOL`` and
  every gradient leaf (the encoder's and the cross-attention's too)
  within ``GRAD_RTOL`` of its largest magnitude, and the gradient into
  ``encoder_out`` the same way: the cross-attention's backward (the
  gradient of dense non-causal attention at S != T) reaches the
  frontend; the loss under the config's own ``mp`` within
  ``BF16_LOSS_RTOL``;
* ``ops.FlashAttentionDenseGrad`` non-causal at S < T and S > T against
  ``jax.vjp`` of the reference's ``dense_attention`` within 1e-5;
* one ``make_train_step`` step of grok-1 as its full config trains it
  (bfloat16 params, 8-bit Adam, ``grad_accum`` 4) at the reduced
  widths.  With float32 compute over the bfloat16 params every new
  param is bfloat16 and within one bfloat16 ulp of the reference's
  (measured: all equal).  Under the config's own bfloat16 compute the
  loss is held within ``BF16_LOSS_RTOL``, and every new param within
  two Adam steps (``2 lr``) and one ulp of the reference's: XLA and ATen
  round the bfloat16 gradients differently, and where a gradient near 0
  takes the other sign, Adam's first step moves the param by ``lr`` the
  other way (measured: 1.8% of the params more than one ulp apart, none
  by more than 9.8e-4, two steps of one ulp at magnitudes 0.0625 to
  0.125), and at most ``BF16_FAR_SHARE`` of them more than one ulp
  apart: a step that left the params as they were would put most of them
  there.  The share that differs is printed;
* ``launch.train --mode lm`` on the CPU for the three configs, with a
  checkpoint and ``--resume``, and a bfloat16 param tree through a
  checkpoint bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import torch_lm_parity as lp
from repro.configs import base as jcfgs
from repro.core.qconfig import MixedPrecisionConfig as JMP
from repro.launch import steps as jsteps
from repro.models import attention as jattn
from repro.models import transformer as jtr
from repro.optim import adam as jadam
from repro_torch import checkpoint as ckpt_lib
from repro_torch.configs import base as cfgs
from repro_torch.core import ptq
from repro_torch.core.qconfig import MixedPrecisionConfig
from repro_torch.kernels import ops
from repro_torch.launch import steps
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer
from repro_torch.optim import adam

FRONTENDS = ["whisper-tiny", "llama-3.2-vision-90b"]
NAMES = FRONTENDS + ["grok-1-314b"]
GROK_BATCH = (4, 32)         # grad_accum 4: micro-batches of one sequence
BF16_FAR_SHARE = 0.05        # params more than one ulp from JAX's


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's many small ops: beside the
    other test workers on the same cores, more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, seed=1, b=lp.BATCH, s=lp.SEQ):
    """Tokens and labels, and seeded stub embeddings for a frontend
    config."""
    out = lp.batch(cfg.vocab, seed, b, s)
    if cfg.cross_attn or cfg.encoder_layers:
        shape = (b, max(cfg.encoder_seq, 4), cfg.d_model)
        out["encoder_out"] = (np.random.default_rng(seed + 100).normal(
            size=shape) * 0.02).astype(np.float32)
    return out


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_grads_match_jax_fp32(name):
    jcfg, cfg = lp.configs(name)
    tp, jp = lp.params(name)
    b = _batch(cfg)
    jb = lp.jax_batch(b)
    enc = jb.pop("encoder_out", None)

    def jfn(p, e):
        return jtr.loss_fn(jcfg, p, {**jb, "encoder_out": e})
    (jl, jm), (jg, jge) = lp.compiled(jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True), jp, enc)(jp, enc)
    leaves = [t.requires_grad_(True) for _, t in ptq.tree_tensors(tp)]
    tb = lp.torch_batch(b)
    if enc is not None:
        tb["encoder_out"].requires_grad_(True)
    loss, metrics = transformer.loss_fn(cfg, tp, tb)
    inputs = leaves + ([tb["encoder_out"]] if enc is not None else [])
    grads = torch.autograd.grad(loss, inputs, allow_unused=True)
    loss = float(loss.detach())
    assert abs(loss - float(jl)) <= lp.LOSS_RTOL * abs(float(jl))
    np.testing.assert_allclose(float(metrics["ce_loss"].detach()),
                               float(jm["ce_loss"]), rtol=lp.LOSS_RTOL)
    tree = steps._unflatten(tp, [torch.zeros_like(p) if g is None else g
                                 for p, g in zip(leaves, grads)])
    lp.assert_grads_close(tree, jg)
    if enc is not None:
        lp.assert_grads_close({"encoder_out": grads[-1]},
                              {"encoder_out": jge})
        assert float(np.abs(np.asarray(jge)).max()) > 0


@pytest.mark.parametrize("name", NAMES)
def test_loss_matches_jax_under_own_mp(name):
    jcfg, cfg = lp.configs(name, fp32=False)
    assert cfg.mp.compute_dtype == "bfloat16"
    tp, jp = lp.params(name)
    b = _batch(cfg)
    jl = lp.jax_loss_own_mp(jcfg, jp, b)
    loss = lp.torch_loss_own_mp(cfg, tp, b)
    assert loss.dtype == torch.float32
    assert abs(float(loss) - float(jl)) <= lp.BF16_LOSS_RTOL * float(jl)


@pytest.mark.parametrize("s,t", [(7, 40), (40, 7), (33, 33)])
def test_cross_attention_grad_matches_jax_dense_attention(s, t):
    """Non-causal at S < T (cross-attention over the encoder output), S >
    T (llama-vision's prompt longer than its patches) and S = T (the
    encoder's self-attention)."""
    rng = np.random.default_rng(s * t)
    b, kv, g, d = 2, 2, 3, 16
    q = rng.normal(size=(b, s, kv * g, d)).astype(np.float32)
    k = (rng.normal(size=(b, t, kv, d)) * 1.5).astype(np.float32)
    v = rng.normal(size=(b, t, kv, d)).astype(np.float32)
    ct = rng.normal(size=(b, s, kv * g, d)).astype(np.float32)

    def ref(q, k, v):
        out = jattn.dense_attention(q.reshape(b, s, kv, g, d), k, v,
                                    causal=False)
        return out.reshape(b, s, kv * g, d)

    def out_and_grads(q, k, v, ct):
        out, vjp = jax.vjp(ref, q, k, v)
        return (out,) + vjp(ct)
    args = tuple(jnp.asarray(x) for x in (q, k, v, ct))
    jout, jdq, jdk, jdv = lp.compiled(out_and_grads, *args)(*args)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    out = ops.FlashAttentionDenseGrad.apply(tq, tk, tv, False, None, None,
                                            d ** -0.5)
    dq, dk, dv = torch.autograd.grad(out, (tq, tk, tv),
                                     torch.from_numpy(ct))
    for got, want in ((out, jout), (dq, jdq), (dk, jdk), (dv, jdv)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def _to_jax_bf16(tree):
    if isinstance(tree, dict):
        return {k: _to_jax_bf16(v) for k, v in tree.items()}
    # a copy: JAX may alias a numpy buffer, and the port's step updates
    # its params in place
    return jnp.asarray(tree.view(torch.uint16).numpy().view(
        ml_dtypes.bfloat16).copy())


def _ordered(bits):
    """bfloat16 bits as integers in the order of the values they code,
    so the difference of two counts ulps."""
    bits = bits.astype(np.int32)
    return np.where(bits & 0x8000, -(bits & 0x7FFF), bits)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_grok_bf16_params_eightbit_adam_step_matches_jax(compute):
    name = "grok-1-314b"
    full_mp = cfgs.get(name).mp
    assert (full_mp.param_dtype, jcfgs.get(name).mp.param_dtype) == \
        ("bfloat16", "bfloat16")
    jcfg = dataclasses.replace(
        jcfgs.get_reduced(name), grad_accum=4, remat=False,
        scan_layers=False, mp=JMP(compute_dtype=compute,
                                  param_dtype="bfloat16"))
    cfg = dataclasses.replace(
        cfgs.get_reduced(name), grad_accum=4,
        mp=MixedPrecisionConfig(compute_dtype=compute,
                                param_dtype="bfloat16"))
    assert cfg.optimizer_8bit and jcfg.optimizer_8bit
    tp = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                 "cpu", dtype=torch.bfloat16)
    jp = _to_jax_bf16(tp)
    b = lp.batch(cfg.vocab, 1, *GROK_BATCH)
    jstep, jacfg = jsteps.make_train_step(jcfg)
    jopt = jadam.adam_init(jp, jacfg)
    args = (jp, jopt, lp.jax_batch(b), {})
    jnew, _, _, jm = lp.compiled(jstep, *args)(*args)
    tstep, acfg = steps.make_train_step(cfg)
    assert acfg.eightbit
    new, opt, _, m = tstep(tp, adam.adam_init(tp, acfg), lp.torch_batch(b),
                           {})
    rtol = lp.LOSS_RTOL if compute == "float32" else lp.BF16_LOSS_RTOL
    assert abs(float(m["loss"]) - float(jm["loss"])) <= \
        rtol * float(jm["loss"])
    want = lp.jax_flat(jnew)
    n = differ = far = 0
    for k, x in ptq.tree_tensors(new):
        assert x.dtype == torch.bfloat16, k
        w = want[k]
        assert w.dtype == ml_dtypes.bfloat16, k
        ulps = np.abs(_ordered(x.view(torch.uint16).numpy())
                      - _ordered(w.view(np.uint16)))
        n, differ = n + ulps.size, differ + int((ulps > 0).sum())
        far += int((ulps > 1).sum())
        if compute == "float32":
            assert ulps.max() <= 1, (k, int(ulps.max()))
        else:
            # Adam's step taken either way, plus an ulp of the larger
            # new value: each package rounds its step to bfloat16
            x32, w32 = x.float().numpy(), w.astype(np.float32)
            ulp = np.spacing(np.maximum(np.abs(x32), np.abs(w32)).astype(
                ml_dtypes.bfloat16)).astype(np.float32)
            err = np.abs(x32 - w32)
            assert (err <= 2 * acfg.lr + ulp).all(), (k, float(err.max()))
    assert far / n <= BF16_FAR_SHARE, (far, n)
    assert isinstance(opt.m["embed"]["w"], adam.BlockQuantized)
    print(f"grok step, {compute} compute over bfloat16 params: "
          f"{differ / n:.4%} of the params differ from JAX's, "
          f"{far / n:.4%} by more than one ulp")


def test_launch_train_lm_frontends_on_cpu(tmp_path, capsys):
    for name in NAMES:
        argv = ["--mode", "lm", "--arch", name, "--reduced", "--steps", "2",
                "--batch", "2", "--seq", "16", "--device", "cpu"]
        if name == "grok-1-314b":
            argv += ["--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
        assert launch_train.main(argv) == 0
        out = capsys.readouterr().out
        assert f"[train/lm] {name}-reduced" in out
        losses = [float(line.split("loss")[1].split()[0]) for line in
                  out.splitlines() if line.strip().startswith("step")]
        assert len(losses) == 2 and all(np.isfinite(losses))
    # grok's params in bfloat16 (the full config's param_dtype) through a
    # checkpoint, bit for bit
    cfg = dataclasses.replace(cfgs.get_reduced("grok-1-314b"),
                              mp=cfgs.get("grok-1-314b").mp)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(1),
                                     "cpu", dtype=torch.bfloat16)
    ckpt_lib.save_checkpoint(tmp_path / "bf16", {"params": params}, step=0)
    back = ckpt_lib.load_checkpoint(tmp_path / "bf16", {"params": params},
                                    step=0)["params"]
    for (k, a), (_, b) in zip(ptq.tree_tensors(params),
                              ptq.tree_tensors(back)):
        assert b.dtype == torch.bfloat16 and torch.equal(
            a.view(torch.uint16), b.view(torch.uint16)), k
    assert launch_train.main(argv[:-4] + ["--ckpt-dir", str(tmp_path),
                                          "--resume"]) == 0
    assert "resumed params from step 1" in capsys.readouterr().out
