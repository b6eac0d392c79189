"""PPO (Schulman et al. 2017): GAE and the clipped surrogate over
minibatch epochs, with the ActorQ actors.

Counterpart of ``repro/rl/ppo.py``.  ``PPOConfig`` keeps the reference's
fields and defaults.  With ``actor_backend="int8"`` (or ``"int4"``) the
cache is packed once per iteration (calibrated with ``calib_batch``, so
kernel B2 on the card, else B1 a layer) and the behaviour logits,
log-probs, per-step values and the bootstrap value all come from the
packed head, so the clipped ratio corrects for the quantized actor as for
any policy lag.  The minibatch learner stays fp32 (QAT sites, kernel B5,
under a QAT config).

* ``gae`` -- advantages and returns, a reversed loop over time in the
  reference's order.
* ``make_learner`` -- everything after the rollout: GAE, the normalised
  advantages, ``epochs`` x ``n_minibatches`` Adam steps over the given
  permutations (one an epoch).
* ``make_iteration`` -- the rollout, one permutation an epoch from the
  loop's generator, then the learner; and the greedy ``act_fn``.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.core import metrics as metrics_lib
from repro_torch.core.qconfig import QuantConfig
from repro_torch.device import resolve_device
from repro_torch.optim.adam import AdamConfig, adam_update
from repro_torch.rl import a2c, actorq, common
from repro_torch.rl.env import Env, StepOut, batched_env, rollout
from repro_torch.rl.networks import Network

init = a2c.init


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """PPO hyperparameters (the reference's fields and defaults).
    ``calib_batch > 0`` (with a quantized backend) calibrates each
    iteration's cache from as many live observations, so the rollout runs
    the fused MLP kernel.  ``kernel_backend`` takes only ``"auto"``."""

    lr: float = 3e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    n_envs: int = 16
    n_steps: int = 64
    epochs: int = 4
    n_minibatches: int = 4
    value_coef: float = 0.5
    entropy_coef: float = 0.01
    quant: QuantConfig = QuantConfig.none()
    actor_backend: str = "fp32"
    kernel_backend: str = "auto"
    calib_batch: int = 0


def gae(rewards: torch.Tensor, dones: torch.Tensor, values: torch.Tensor,
        last_value: torch.Tensor, gamma: float, lam: float):
    """``(advantages, returns)`` of ``(T, B)`` rewards, dones and values,
    bootstrapped from ``last_value``: a reversed loop over time."""
    adv = torch.zeros_like(last_value)
    next_value = last_value
    advs = [None] * rewards.shape[0]
    for t in reversed(range(rewards.shape[0])):
        delta = rewards[t] + gamma * next_value * (1 - dones[t]) - values[t]
        adv = delta + gamma * lam * (1 - dones[t]) * adv
        next_value = values[t]
        advs[t] = adv
    advs = torch.stack(advs)
    return advs, advs + values


def make_learner(env: Env, net: Network, cfg: PPOConfig):
    """``learn(state, traj, last_value, perms) -> (state, metrics)``.

    ``traj`` is the rollout (a ``StepOut`` over ``(T, B)`` whose
    ``logits_or_value`` is the behaviour ``(logits, value, logp)``),
    ``last_value`` the behaviour value of the observation after it and
    ``perms`` one permutation of the ``T * B`` samples per epoch.  Each
    epoch takes ``n_minibatches`` minibatches of ``T * B //
    n_minibatches`` from its permutation, in order, one Adam step each;
    the observers thread through the steps.  ``metrics``: the mean of the
    epochs' mean losses and the variance of the behaviour action
    distribution, on the device.
    """
    adam_cfg = AdamConfig(lr=cfg.lr)
    heads = common.make_heads(net, cfg.quant, env.spec.n_actions)

    def learn(state: common.TrainState, traj: StepOut, last_value,
              perms: Sequence[torch.Tensor]):
        logits_b, values_b, logp_b = traj.logits_or_value
        advs, returns = gae(traj.reward, traj.done, values_b, last_value,
                            cfg.gamma, cfg.gae_lambda)
        advs_n = (advs - advs.mean()) / (advs.std(correction=0) + 1e-8)

        def flat(x):
            return x.reshape((-1,) + tuple(x.shape[2:]))
        data = dict(obs=flat(traj.obs), action=flat(traj.action),
                    logp=flat(logp_b), adv=flat(advs_n), ret=flat(returns))
        n_data = data["adv"].shape[0]
        mb = n_data // cfg.n_minibatches
        params, opt, observers = state.params, state.opt, state.observers
        epoch_losses = []
        for perm in perms:
            losses = []
            for idx in perm[:mb * cfg.n_minibatches].reshape(
                    cfg.n_minibatches, mb):
                b = {k: v[idx] for k, v in data.items()}
                with torch.enable_grad():
                    leaves = common.grad_leaves(params)
                    logits, values, new_coll = heads(
                        leaves, b["obs"], observers, state.step)
                    logp = common.log_prob(logits, b["action"])
                    ratio = torch.exp(logp - b["logp"])
                    clipped = torch.clamp(ratio, 1 - cfg.clip_eps,
                                          1 + cfg.clip_eps)
                    pg = -torch.minimum(ratio * b["adv"],
                                        clipped * b["adv"]).mean()
                    v_loss = torch.square(values - b["ret"]).mean()
                    loss = pg + cfg.value_coef * v_loss \
                        - cfg.entropy_coef * common.entropy(logits)
                    grads = common.tree_grad(loss, leaves)
                params, opt, _ = adam_update(grads, opt, params, adam_cfg)
                observers = new_coll
                losses.append(loss.detach())
            epoch_losses.append(torch.mean(torch.stack(losses)))
        state = common.TrainState(params, opt, observers, state.step + 1, ())
        return state, {
            "loss": torch.mean(torch.stack(epoch_losses)),
            "action_dist_variance":
                metrics_lib.action_distribution_variance(logits_b)}
    return learn


def make_iteration(env: Env, net: Network, cfg: PPOConfig, device=None):
    """``(iteration, act_fn, benv)`` of the fused driver.

    ``iteration(state, env_state, obs, generator) -> (state, env_state,
    obs, metrics)``: a rollout of ``n_steps`` over ``n_envs`` envs that
    samples from the packed actor's head (one cache an iteration,
    calibrated with ``calib_batch``) or the fp32 head under the QAT
    context, keeping the behaviour logits, values and log-probs; the
    bootstrap value from the same head; ``epochs`` permutations from
    ``generator``; then ``make_learner``'s steps.  ``metrics`` add the
    reward per finished episode.  ``device=None`` is ``cuda``.
    """
    common.check_config(cfg)
    resolve_device(device)
    benv = batched_env(env, cfg.n_envs)
    n_act = env.spec.n_actions
    heads = common.make_heads(net, cfg.quant, n_act)
    learn = make_learner(env, net, cfg)
    quantized = actorq.is_quantized(cfg.actor_backend)

    def iteration(state: common.TrainState, env_state, obs,
                  generator: torch.Generator):
        """One rollout and the minibatch epochs."""
        if quantized:
            qparams = actorq.make_actor_cache(
                state.params, cfg.actor_backend,
                calib_obs=actorq.calib_slice(obs, cfg.calib_batch)
                if cfg.calib_batch else None)

            def head(o):
                out = actorq.quantized_apply(qparams, o)
                return out[..., :n_act], out[..., n_act]
        else:
            def head(o):
                return heads(state.params, o, state.observers,
                             state.step)[:2]

        def policy(_params, o, g):
            logits, value = head(o)
            action = actorq.sample_categorical(logits, g)
            return action, (logits, value, common.log_prob(logits, action))
        env_state, last_obs, traj = rollout(benv, policy, state.params,
                                            env_state, obs, generator,
                                            cfg.n_steps)
        last_value = head(last_obs)[1]
        n_data = cfg.n_steps * cfg.n_envs
        perms = [torch.randperm(n_data, generator=generator,
                                device=generator.device).to(obs.device)
                 for _ in range(cfg.epochs)]
        state, metrics = learn(state, traj, last_value, perms)
        metrics["reward"] = torch.sum(traj.reward) / torch.clamp(
            torch.sum(traj.done), min=1.0)
        return state, env_state, last_obs, metrics

    return iteration, a2c.make_act_fn(net, cfg, n_act), benv
