"""The LM training step.

Counterpart of ``repro/launch/steps.py: make_train_step``.  One step
casts the master params (float32, or the config's ``param_dtype``:
grok-1's bfloat16) to the config's compute dtype
(``core.mixed_precision.to_compute``), takes the value and gradient of
``transformer.loss_fn`` (the gradient flows back through the cast to the
masters, in their dtype), accumulates ``cfg.grad_accum`` micro-batches as
the reference does (every batch entry, ``encoder_out`` too, split on its
leading axis; each micro-batch from the step's incoming QAT collection;
the collection and metrics of the last one are kept, the loss and
gradients are averaged, the sum in float32 as the reference's
``zero_g``), then applies ``optim.adam.adam_update``, which returns each
param in its own dtype.  The reference's shardings and
``lower_step`` have no counterpart yet (ROADMAP queue A, item 14b).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs import base as cfgs
from repro_torch.core import mixed_precision as mp_lib
from repro_torch.core.ptq import tree_map, tree_tensors
from repro_torch.models import transformer
from repro_torch.optim import adam as adam_lib

Tree = Any


def _unflatten(params: Tree, leaves: list) -> Tree:
    """``leaves`` (in ``tree_tensors`` order) in ``params``' dict
    structure."""
    it = iter(leaves)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        return next(it)
    return walk(params)


def value_and_grad(cfg: cfgs.ArchConfig, params: Tree,
                   batch: Dict[str, torch.Tensor], qat_collection,
                   step: torch.Tensor):
    """``(loss, metrics, grads)`` of ``loss_fn`` at the compute dtype,
    the gradients in ``params``' structure and dtypes; ``loss`` and the
    metrics detached."""
    leaves = [t.detach().requires_grad_(True)
              for _, t in tree_tensors(params)]
    with torch.enable_grad():
        p_c = mp_lib.to_compute(_unflatten(params, leaves), cfg.mp)
        loss, metrics = transformer.loss_fn(
            cfg, p_c, batch, qat_collection=qat_collection, step=step)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    metrics = {k: (v.detach() if isinstance(v, torch.Tensor) else v)
               for k, v in metrics.items()}
    return loss.detach(), metrics, _unflatten(params, grads)


def make_train_step(cfg: cfgs.ArchConfig,
                    adam_cfg: Optional[adam_lib.AdamConfig] = None):
    """``(train_step, adam_cfg)``; ``train_step(params, opt_state, batch,
    qat_collection) -> (params, opt_state, qat_collection, metrics)``,
    ``metrics`` holding ``loss``, ``ce_loss``, ``aux_loss`` and the
    pre-clip ``grad_norm`` (device scalars: no host sync).  ``batch``
    holds ``tokens`` and ``labels`` ``(B, S)`` on the params' device (and
    ``encoder_out`` for the encoder and cross-attention configs); the
    step is ``opt_state.step`` (the QAT delay reads it)."""
    adam_cfg = adam_cfg or adam_lib.AdamConfig(eightbit=cfg.optimizer_8bit)

    def train_step(params, opt_state, batch, qat_collection):
        step = opt_state.step
        a = cfg.grad_accum
        if a > 1:
            loss = torch.zeros((), device=step.device)
            grads = tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), params)
            for i in range(a):
                micro = {k: v.reshape((a, v.shape[0] // a) + v.shape[1:])[i]
                         for k, v in batch.items()}
                loss_i, metrics, grads_i = value_and_grad(
                    cfg, params, micro, qat_collection, step)
                loss = loss + loss_i
                grads = tree_map(torch.add, grads, grads_i)
            loss = loss / a
            grads = tree_map(lambda g: g / a, grads)
        else:
            loss, metrics, grads = value_and_grad(cfg, params, batch,
                                                  qat_collection, step)
        with torch.no_grad():
            new_params, new_opt, stats = adam_lib.adam_update(
                grads, opt_state, params, adam_cfg)
        out = {"loss": loss, "ce_loss": metrics["ce_loss"],
               "aux_loss": metrics["aux_loss"], **stats}
        return new_params, new_opt, metrics["qat_collection"], out

    return train_step, adam_cfg
