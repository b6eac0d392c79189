"""Advantage actor-critic (synchronous A2C, Mnih et al. 2016), with the
ActorQ actors.

Counterpart of ``repro/rl/a2c.py``.  ``A2CConfig`` keeps the reference's
fields and defaults.  The net's head is ``n_actions`` logits and one
value.  With ``actor_backend="int8"`` (or ``"int4"``) the rollout samples
from the packed actor's categorical head (``actorq.make_sampling_policy``:
kernel B1 a layer on the card, or B2 once when ``calib_batch``
calibrates the cache), packed once per iteration; the learner stays fp32
(QAT sites, kernel B5, under a QAT config).

* ``make_learner`` -- everything after the rollout: discounted returns
  bootstrapped from the learner's value of the last observation (a
  reversed loop over time, in the reference's order), the policy-gradient,
  value and entropy losses over the whole trajectory, one Adam step.
* ``make_iteration`` -- the rollout, then the learner; and the greedy
  ``act_fn``.  With a mesh axis it is one rank's data-parallel slice
  (``rl.distributed.make_distributed_a2c``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import metrics as metrics_lib
from repro_torch.core.ptq import tree_tensors
from repro_torch.core.qconfig import QuantConfig
from repro_torch.device import resolve_device
from repro_torch.optim.adam import AdamConfig, adam_init, adam_update
from repro_torch.rl import actorq, common
from repro_torch.rl.env import Env, StepOut, batched_env, rollout
from repro_torch.rl.networks import Network


@dataclasses.dataclass(frozen=True)
class A2CConfig:
    """A2C hyperparameters (the reference's fields and defaults).
    ``calib_batch > 0`` (with a quantized backend) calibrates each
    iteration's cache from as many live observations, so the rollout runs
    the fused MLP kernel.  ``kernel_backend`` takes only ``"auto"``."""

    lr: float = 7e-4
    gamma: float = 0.99
    n_envs: int = 16
    n_steps: int = 8
    value_coef: float = 0.5
    entropy_coef: float = 0.01
    quant: QuantConfig = QuantConfig.none()
    actor_backend: str = "fp32"
    kernel_backend: str = "auto"
    calib_batch: int = 0


def init(generator: torch.Generator, env: Env, net: Network,
         cfg) -> common.TrainState:
    """A fresh train state: params from the CPU ``generator`` (on the
    network's device), zero Adam moments, no extras."""
    params = net.init(generator)
    device = next(t for _, t in tree_tensors(params)).device
    return common.TrainState(
        params=params, opt=adam_init(params, AdamConfig(lr=cfg.lr)),
        observers={}, step=torch.zeros((), dtype=torch.int32,
                                       device=device), extras=())


def discounted_returns(rewards: torch.Tensor, dones: torch.Tensor,
                       last_value: torch.Tensor,
                       gamma: float) -> torch.Tensor:
    """``(T, B)`` returns ``G_t = r_t + gamma * G_{t+1} * (1 - done_t)``
    from ``G_T = last_value``, a reversed loop over time (the reference's
    reverse scan)."""
    carry, out = last_value, [None] * rewards.shape[0]
    for t in reversed(range(rewards.shape[0])):
        carry = rewards[t] + gamma * carry * (1 - dones[t])
        out[t] = carry
    return torch.stack(out)


def make_learner(env: Env, net: Network, cfg: A2CConfig):
    """``learn(state, traj, last_obs, reduce=None) -> (state, metrics)``:
    one fp32 learner step on a rollout ``traj`` (a ``StepOut`` over ``(T,
    B)``) and the observation after it.  The observers advance by the
    trajectory's forward (the last observation's is dropped).
    ``reduce`` (a mesh axis's ``mean``, ``rl.distributed``) takes the
    gradients, the loss and the new observers together before the Adam
    step; ``None`` is the identity.  ``metrics``: loss, entropy and the
    variance of the learner's action distribution, on the device (the
    last two the rank's own)."""
    adam_cfg = AdamConfig(lr=cfg.lr)
    heads = common.make_heads(net, cfg.quant, env.spec.n_actions)

    def learn(state: common.TrainState, traj: StepOut, last_obs,
              reduce=None):
        with torch.enable_grad():
            leaves = common.grad_leaves(state.params)
            logits, values, new_coll = heads(leaves, traj.obs,
                                             state.observers, state.step)
            _, last_value, _ = heads(leaves, last_obs, state.observers,
                                     state.step)
            returns = discounted_returns(traj.reward, traj.done,
                                         last_value.detach(), cfg.gamma)
            adv = returns.detach() - values
            logp_a = common.log_prob(logits, traj.action)
            ent = common.entropy(logits)
            pg_loss = -(adv.detach() * logp_a).mean()
            v_loss = torch.square(adv).mean()
            loss = pg_loss + cfg.value_coef * v_loss \
                - cfg.entropy_coef * ent
            grads = common.tree_grad(loss, leaves)
        loss = loss.detach()
        if reduce is not None:
            grads, loss, new_coll = reduce((grads, loss, new_coll))
        params, opt, _ = adam_update(grads, state.opt, state.params,
                                     adam_cfg)
        state = common.TrainState(params, opt, new_coll, state.step + 1, ())
        return state, {
            "loss": loss, "entropy": ent.detach(),
            "action_dist_variance":
                metrics_lib.action_distribution_variance(logits.detach())}
    return learn


def make_act_fn(net: Network, cfg, n_actions: int):
    """``act_fn(params, obs, observers=None, step=1 << 30)``: greedy int32
    actions over the first ``n_actions`` outputs, under the QAT
    context."""
    heads = common.make_heads(net, cfg.quant, n_actions)

    def act_fn(params, obs, observers=None, step=1 << 30):
        """Greedy actions (int32) under the QAT context at ``step``."""
        logits, _, _ = heads(params, obs, observers or {},
                             torch.as_tensor(step, device=obs.device))
        return torch.argmax(logits, dim=-1).to(torch.int32)
    return act_fn


def make_iteration(env: Env, net: Network, cfg: A2CConfig, device=None,
                   ax=None):
    """``(iteration, act_fn, benv)`` of the fused driver.

    ``iteration(state, env_state, obs, generator) -> (state, env_state,
    obs, metrics)``: a rollout of ``n_steps`` over ``n_envs`` envs that
    samples from the packed actor's head (one cache an iteration,
    calibrated with ``calib_batch`` on the rollout's own observations) or
    the fp32 head under the QAT context, then ``make_learner``'s step;
    ``metrics`` add the reward per finished episode.  ``device=None`` is
    ``cuda``.

    ``ax`` (an ``rl.distributed.Axis``: its ``size`` and ``mean``) makes
    it one rank's slice: ``n_envs / size`` envs, the gradients, loss and
    observers averaged through ``mean`` before the Adam step (so every
    rank applies the same step), and the reward averaged too; the
    entropy and variance stay the rank's own.  ``None`` is the whole run
    in one process.
    """
    common.check_config(cfg)
    resolve_device(device)
    size, reduce = (1, None) if ax is None else (ax.size, ax.mean)
    if cfg.n_envs % size:
        raise ValueError(f"n_envs {cfg.n_envs} must divide by the mesh "
                         f"{ax.name!r} axis size {size}")
    benv = batched_env(env, cfg.n_envs // size)
    heads = common.make_heads(net, cfg.quant, env.spec.n_actions)
    learn = make_learner(env, net, cfg)
    quantized = actorq.is_quantized(cfg.actor_backend)
    sampling = actorq.make_sampling_policy(env.spec) if quantized else None

    def iteration(state: common.TrainState, env_state, obs,
                  generator: torch.Generator):
        """One rollout and one learner step."""
        if quantized:
            qparams = actorq.make_actor_cache(
                state.params, cfg.actor_backend,
                calib_obs=actorq.calib_slice(obs, cfg.calib_batch)
                if cfg.calib_batch else None)

            def policy(_params, o, g):
                return sampling(qparams, o, g)
        else:
            def policy(params, o, g):
                logits, _, _ = heads(params, o, state.observers, state.step)
                return actorq.sample_categorical(logits, g), logits
        env_state, last_obs, traj = rollout(benv, policy, state.params,
                                            env_state, obs, generator,
                                            cfg.n_steps)
        state, metrics = learn(state, traj, last_obs, reduce=reduce)
        reward = torch.sum(traj.reward) / torch.clamp(torch.sum(traj.done),
                                                      min=1.0)
        metrics["reward"] = reward if reduce is None else reduce(reward)
        return state, env_state, last_obs, metrics

    return iteration, make_act_fn(net, cfg, env.spec.n_actions), benv
