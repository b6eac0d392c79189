"""Shared RL plumbing of the port: the train state, the QAT context
wiring, evaluation-time quantization and the loss and schedule helpers.

Counterpart of ``repro/rl/common.py:15-126``.  ``state_from_jax``
carries a JAX ``TrainState`` of any of the four algorithms across (as
numpy arrays), so a learner step can start from the same state in both
packages.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from repro_torch.core import affine, fake_quant, ptq
from repro_torch.core.qconfig import QuantConfig
from repro_torch.device import resolve_device
from repro_torch.optim.adam import AdamState
from repro_torch.rl import actorq
from repro_torch.rl import buffer as rb


class TrainState(NamedTuple):
    """Learner params, Adam state, QAT observers, the update step (0-d
    int32) and the algorithm's extras (target params, replay, ...)."""

    params: Any
    opt: AdamState
    observers: Dict[str, fake_quant.ObserverState]
    step: torch.Tensor
    extras: Any = ()


def check_config(cfg) -> None:
    """Raise ``ValueError`` for an algorithm config whose actor backend is
    unknown or whose ``kernel_backend`` is not ``"auto"``: the port
    dispatches its kernels by device."""
    actorq.validate_actor_backend(cfg.actor_backend)
    if cfg.kernel_backend != "auto":
        raise ValueError("the port dispatches kernels by device; "
                         f"kernel_backend must be 'auto', got "
                         f"{cfg.kernel_backend!r}")


def make_ctx(quant: QuantConfig, observers, step):
    """The QAT context of one forward at update ``step``."""
    return fake_quant.make_context(quant, observers, step)


class PrefixCtx:
    """A QAT context whose site names carry a prefix (a DDPG actor's and
    critic's observers side by side)."""

    def __init__(self, ctx, prefix: str):
        self._ctx = ctx
        self._prefix = prefix

    @property
    def config(self):
        """The wrapped context's config."""
        return self._ctx.config

    @property
    def enabled(self):
        """The wrapped context's ``enabled``."""
        return self._ctx.enabled

    def weight(self, name, w):
        """The wrapped ``weight`` at ``prefix + name``."""
        return self._ctx.weight(self._prefix + name, w)

    def activation(self, name, x):
        """The wrapped ``activation`` at ``prefix + name``."""
        return self._ctx.activation(self._prefix + name, x)

    def merged_collection(self):
        """The wrapped context's merged collection."""
        return self._ctx.merged_collection()


def make_heads(net, quant: QuantConfig, n_actions: int):
    """``heads(params, obs, observers, step) -> (logits, value,
    observers)`` of an actor-critic net (A2C, PPO): the first
    ``n_actions`` outputs and the one after them, under the QAT context
    at ``step``, with the observers that forward leaves behind."""
    def heads(params, obs, observers, step):
        ctx = make_ctx(quant, observers, step)
        out = net.apply(params, obs, ctx=ctx)
        return out[..., :n_actions], out[..., n_actions], \
            ctx.merged_collection()
    return heads


def log_prob(logits: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    """``log softmax(logits)`` at the integer ``action`` of each row."""
    return torch.gather(torch.log_softmax(logits, dim=-1), -1,
                        action[..., None].to(torch.int64))[..., 0]


def entropy(logits: torch.Tensor) -> torch.Tensor:
    """Mean entropy of the categorical rows of ``logits``."""
    return -torch.sum(torch.softmax(logits, dim=-1)
                      * torch.log_softmax(logits, dim=-1), dim=-1).mean()


def eval_params(params: Any, quant: QuantConfig) -> Any:
    """Algorithm 1/2's evaluation-time quantization of the params.

    PTQ: quantize-dequantize the trained weights (``ptq.ptq_simulate``).
    QAT: the same per-tensor map over each weight's own final range.
    Otherwise the params as they are.
    """
    if quant.is_ptq:
        return ptq.ptq_simulate(params, quant)
    if quant.is_qat:
        def one(leaf):
            if isinstance(leaf, torch.Tensor) and leaf.dim() >= 2 \
                    and leaf.is_floating_point():
                return affine.ptq_tensor(
                    leaf, quant.bits, axis=3 if leaf.dim() == 4 else None)
            return leaf
        return ptq.tree_map(one, params)
    return params


def linear_epsilon(step: torch.Tensor, start: float, end: float,
                   decay_steps: int) -> torch.Tensor:
    """epsilon annealed linearly from ``start`` to ``end`` over
    ``decay_steps`` (a tensor ``step``, so no host sync).  The divisor is
    a tensor, so the card divides correctly rounded, as the CPU does."""
    step = step.to(torch.float32)
    frac = torch.clamp(step / step.new_full((), float(max(decay_steps, 1))),
                       0.0, 1.0)
    return start + frac * (end - start)


def per_beta(state: TrainState, cfg) -> torch.Tensor:
    """The IS-correction exponent of this learner step: ``cfg.is_beta``
    annealed linearly to 1 over ``cfg.is_beta_anneal_updates`` landed
    learner updates (``state.extras.updates``, which warmup does not
    move), so every driver and topology reaches 1 at the same update."""
    return linear_epsilon(state.extras.updates, cfg.is_beta, 1.0,
                          cfg.is_beta_anneal_updates)


def per_learner_step(state: TrainState, generator: torch.Generator, cfg,
                     update_fn):
    """One prioritized learner step on the single (fused) buffer: anneal
    beta, draw a priority-proportional batch with IS weights from
    ``generator``, run ``update_fn(state, batch, size, weights=w) ->
    (state, (loss, td_abs))`` and push ``|td|`` back as the sampled
    slots' priorities.  Returns ``(state, loss)``."""
    beta = per_beta(state, cfg)
    batch, idx, w = rb.per_sample(state.extras.replay, generator,
                                  cfg.batch_size, beta)
    state, (loss, td_abs) = update_fn(
        state, batch, state.extras.replay.replay.size, weights=w)
    per = rb.per_update_priorities(state.extras.replay, idx, td_abs,
                                   cfg.priority_exponent)
    return state._replace(extras=state.extras._replace(replay=per)), loss


def soft_update(target: Any, online: Any, tau: float) -> Any:
    """Polyak averaging, leaf by leaf: ``(1 - tau) * target + tau *
    online`` (DDPG's target nets)."""
    return ptq.tree_map(lambda t, o: (1 - tau) * t + tau * o, target,
                        online)


def grad_leaves(params: Any) -> Any:
    """``params`` as fresh autograd leaves (detached copies that require
    grad), for one learner step's forward."""
    return ptq.tree_map(lambda p: p.detach().requires_grad_(True), params)


def tree_grad(loss: torch.Tensor, leaves: Any) -> Any:
    """The gradient of ``loss`` for every leaf of ``leaves`` (from
    ``grad_leaves``), as a tree of the same structure."""
    flat = [t for _, t in ptq.tree_tensors(leaves)]
    return _unflatten(leaves, iter(torch.autograd.grad(loss, flat)))


def _unflatten(tree, it):
    """``tree`` (nested dicts) with its leaves replaced, in sorted-key
    order, by the next items of ``it`` (``tree_tensors``' order)."""
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], it) for k in sorted(tree)}
    return next(it)


def huber(x: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """Elementwise Huber loss."""
    a = torch.abs(x)
    return torch.where(a <= delta, 0.5 * x * x, delta * (a - 0.5 * delta))


def state_from_jax(state: Any, device=None) -> TrainState:
    """The port's ``TrainState`` from a JAX one (fields read as numpy).

    Carries the params, Adam's step and moments, the observers, the step
    and the extras -- DQN's (target params, the uniform or prioritized
    replay, single or sharded, and the update count), DDPG's (critic
    params, both target nets, the critic's Adam state, the replay and
    the update count) or PPO's and A2C's ``()`` -- with dtypes kept, onto
    ``device`` (``None`` is ``cuda``).
    """
    from repro_torch.rl import ddpg, dqn     # both import this module
    device = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.array(a)).to(device)

    def tree(x):
        if isinstance(x, dict):
            return {k: tree(v) for k, v in x.items()}
        return t(x)

    def adam(o):
        return AdamState(t(o.step), tree(o.m), tree(o.v))

    observers = {k: fake_quant.ObserverState(t(o.vmin), t(o.vmax),
                                             t(o.initialized))
                 for k, o in state.observers.items()}

    def replay(r):
        if hasattr(r, "tree"):
            return rb.PrioritizedReplayState(replay(r.replay), t(r.tree),
                                             t(r.max_priority))
        return rb.ReplayState(rb.Transition(*(t(x) for x in r.data)),
                              t(r.index), t(r.size))

    extras = state.extras
    if hasattr(extras, "critic_params"):
        extras = ddpg.DDPGExtras(
            critic_params=tree(extras.critic_params),
            target_actor=tree(extras.target_actor),
            target_critic=tree(extras.target_critic),
            critic_opt=adam(extras.critic_opt),
            replay=replay(extras.replay), updates=t(extras.updates))
    elif hasattr(extras, "target_params"):
        extras = dqn.DQNExtras(target_params=tree(extras.target_params),
                               replay=replay(extras.replay),
                               updates=t(extras.updates))
    elif extras != ():
        raise TypeError(f"unknown extras {type(extras).__name__}")
    return TrainState(params=tree(state.params), opt=adam(state.opt),
                      observers=observers, step=t(state.step), extras=extras)
