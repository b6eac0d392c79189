"""Shared set-up of the LM training parity tests: the same params and
batches in both packages.

The params are drawn by the port (``transformer.init_params`` from a
seeded CPU generator) and carried to JAX as arrays, which is cheaper on
the CPU than tracing the reference's initializer.  The reference runs
with ``remat`` and ``scan_layers`` off and is compiled without XLA's
backend optimizations (``compiled``): these change how it is compiled,
not what it computes beyond rounding, and compiling is most of these
tests' time.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import base as jcfgs
from repro.core import mixed_precision as jmp
from repro.core.qconfig import MixedPrecisionConfig as JMP
from repro.models import transformer as jtr
from repro_torch.configs import base as cfgs
from repro_torch.core import mixed_precision as mp
from repro_torch.core import ptq
from repro_torch.core.qconfig import MixedPrecisionConfig
from repro_torch.launch import steps
from repro_torch.models import transformer

CONFIGS = ["h2o-danube-1.8b", "gemma2-9b", "codeqwen1.5-7b", "stablelm-12b",
           "mixtral-8x7b", "recurrentgemma-2b", "xlstm-125m"]
BATCH, SEQ = 2, 32
LOSS_RTOL = 1e-5
# each gradient leaf within GRAD_RTOL of its own largest magnitude
# (measured up to 2.0e-5, xlstm's exponential gates; 1.8e-6 elsewhere)
GRAD_RTOL = 1e-4
# and within GRAD_ATOL outright: leaves whose gradient is near 0 (xlstm's
# sLSTM input-gate bias, 3.5e-9 at most) hold no relative digits
GRAD_ATOL = 1e-7
# the loss under the config's own mp (bfloat16 compute): XLA and ATen
# round bfloat16 matmuls and elementwise ops differently (measured up to
# 3.8e-4 at mixtral, 2.4e-4 at codeqwen and xlstm, 8e-6 at most at danube
# and gemma2)
BF16_LOSS_RTOL = 2e-3


def configs(name, fp32=True, quant=None, jquant=None, **kw):
    """The reduced config in both packages (the reference's, and the
    port's with ``kw`` replaced), float32 compute unless ``fp32`` is
    False (the config's own ``mp``), with ``quant`` / ``jquant`` when
    given."""
    jcfg, cfg = jcfgs.get_reduced(name), cfgs.get_reduced(name)
    if fp32:
        jcfg = dataclasses.replace(jcfg, mp=JMP.fp32())
        cfg = dataclasses.replace(cfg, mp=MixedPrecisionConfig.fp32())
    if quant is not None:
        jcfg = dataclasses.replace(jcfg, quant=jquant)
        cfg = dataclasses.replace(cfg, quant=quant)
    jcfg = dataclasses.replace(jcfg, remat=False, scan_layers=False)
    return jcfg, dataclasses.replace(cfg, **kw)


def to_jax(tree):
    if isinstance(tree, dict):
        return {k: to_jax(v) for k, v in tree.items()}
    # a copy: JAX may alias a numpy buffer, and the port's train step
    # updates its params in place
    return jnp.asarray(tree.detach().numpy().copy())


@functools.lru_cache(maxsize=None)
def _params_np(name):
    tp = transformer.init_params(cfgs.get_reduced(name),
                                 torch.Generator().manual_seed(0), "cpu")
    return ptq.tree_map(lambda t: t.numpy(), tp)


def params(name):
    """Fresh torch params and their JAX copy."""
    tp = ptq.tree_map(lambda a: torch.from_numpy(a.copy()),
                      _params_np(name))
    return tp, to_jax(tp)


def batch(vocab, seed=1, b=BATCH, s=SEQ):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def torch_batch(np_batch):
    """Token arrays as int64 tensors, float ones (``encoder_out``) as
    they are."""
    return {k: torch.from_numpy(v).long() if v.dtype.kind in "iu"
            else torch.from_numpy(v) for k, v in np_batch.items()}


FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def compiled(fn, *args):
    """``jax.jit(fn)`` compiled for ``args`` with ``FAST_COMPILE``."""
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)


def jax_batch(np_batch):
    return {k: jnp.asarray(v) for k, v in np_batch.items()}


def jax_value_and_grad(jcfg, jp, np_batch, **kw):
    jb = jax_batch(np_batch)
    fn = jax.value_and_grad(lambda p: jtr.loss_fn(jcfg, p, jb, **kw),
                            has_aux=True)
    (loss, metrics), grads = compiled(fn, jp)(jp)
    return loss, metrics, grads


def jax_loss_own_mp(jcfg, jp, np_batch):
    """The reference's loss at its config's compute dtype (what its
    ``train_step`` differentiates: ``to_compute`` first)."""
    jb = jax_batch(np_batch)

    def fn(p):
        return jtr.loss_fn(jcfg, jmp.to_compute(p, jcfg.mp), jb)[0]
    return compiled(fn, jp)(jp)


def torch_loss_own_mp(cfg, tp, np_batch):
    with torch.no_grad():
        loss, _ = transformer.loss_fn(cfg, mp.to_compute(tp, cfg.mp),
                                      torch_batch(np_batch))
    return loss


def torch_value_and_grad(cfg, tp, np_batch, qat_collection=None, step=0):
    return steps.value_and_grad(cfg, tp, torch_batch(np_batch),
                                qat_collection, torch.tensor(step))


def jax_flat(tree):
    return {"/" + "/".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_grads_close(grads, jgrads, rtol=GRAD_RTOL, atol=GRAD_ATOL):
    want = jax_flat(jgrads)
    got = dict(ptq.tree_tensors(grads))
    assert got.keys() == want.keys()
    for k, g in got.items():
        w = want[k]
        scale = float(np.abs(w).max())
        err = float(np.abs(g.numpy().astype(np.float64) - w).max())
        assert err <= rtol * scale + atol, (k, err, scale)
