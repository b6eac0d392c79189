"""Port parity: ``loss_fn`` of the recurrent configs (recurrentgemma-2b's
RG-LRU scan and local attention, xlstm-125m's mLSTM and sLSTM loops)
against the JAX package on the CPU, at the reduced configs.  Their
backward is autograd through the port's plain recurrent ops, as the
reference's is XLA's autodiff through its own.

The same params and batch go through both (``tests/torch_lm_parity.py``).
In float32 compute the loss is held within 1e-5 relative and every
gradient leaf within 1e-4 of its largest magnitude (the port with remat
on; xlstm's exponential gates measured up to 2.0e-5); under the
config's own ``mp`` (bfloat16 compute) the loss within 2e-3 relative.
"""
import numpy as np
import pytest
import torch

import torch_lm_parity as lp

HERE = ["recurrentgemma-2b", "xlstm-125m"]


@pytest.mark.parametrize("name", HERE)
def test_loss_and_grads_match_jax_fp32(name):
    jcfg, cfg = lp.configs(name)
    tp, jp = lp.params(name)
    b = lp.batch(cfg.vocab)
    jl, jm, jg = lp.jax_value_and_grad(jcfg, jp, b)
    loss, metrics, grads = lp.torch_value_and_grad(cfg, tp, b)
    assert abs(float(loss) - float(jl)) <= lp.LOSS_RTOL * abs(float(jl))
    np.testing.assert_allclose(float(metrics["aux_loss"]),
                               float(jm["aux_loss"]), rtol=1e-5, atol=1e-5)
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
