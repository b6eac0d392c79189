"""DDPG (Lillicrap et al. 2015): a deterministic actor and a Q critic,
replay, soft target updates and Gaussian exploration noise, with the
ActorQ actors.

Counterpart of ``repro/rl/ddpg.py``.  ``DDPGConfig`` keeps the
reference's fields and defaults.  This is the paper's D4PG-style ActorQ
split: with ``actor_backend="int8"`` (or ``"int4"``) the exploration
policy's mu head runs through the packed actor (kernel B1 a layer on the
card, or B2 once, calibrated), while the critic and both gradient paths
stay fp32 (QAT sites, kernel B5, under a QAT config).

* ``make_behaviour_policy`` -- ``clip(mu + noise, -1, 1) * action_scale``
  with ``mu`` the fp32 actor's ``tanh`` under the run's QAT context (its
  observer updates dropped) or the packed actor's.
* ``make_update`` -- one critic step and one actor step on a sampled
  batch, as the reference's, including three things that look like
  slips and are kept (ROADMAP queue C): Adam's moments and step advance
  below warmup (only the params, and the update count, are gated); the
  TD target feeds the target critic the target actor's unscaled
  ``tanh``, while the stored actions and the actor loss are scaled by
  ``action_scale``; and the actor step reads the observers the critic
  step left, so they thread critic -> actor.
* ``make_iteration`` -- rollout, replay write, ``updates_per_iter``
  updates (prioritized ones through ``common.per_learner_step``); and
  the deterministic ``act_fn``.

All random draws come from one ``torch.Generator`` on the data's device,
in turn (the reference splits keys).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core.ptq import tree_map, tree_tensors
from repro_torch.core.qconfig import QuantConfig
from repro_torch.device import resolve_device
from repro_torch.optim.adam import AdamConfig, AdamState, adam_init, \
    adam_update
from repro_torch.rl import actorq
from repro_torch.rl import buffer as rb
from repro_torch.rl import common
from repro_torch.rl.env import Env, batched_env, rollout
from repro_torch.rl.networks import Network, make_network


@dataclasses.dataclass(frozen=True)
class DDPGConfig:
    """DDPG hyperparameters (the reference's fields and defaults).

    ``actor_backend`` picks the exploration policy's mu head: ``"fp32"``,
    or the packed ``"int8"`` / ``"int4"`` cache; ``calib_batch > 0`` (with
    a quantized backend) calibrates that cache from as many live
    observations at every refresh, so the rollout runs the fused MLP
    kernel.  Priorities of prioritized replay are the critic's
    per-transition ``|td|``.  ``kernel_backend`` takes only ``"auto"``.
    """

    actor_lr: float = 1e-3
    critic_lr: float = 1e-3
    gamma: float = 0.99
    tau: float = 0.01
    buffer_size: int = 50_000
    batch_size: int = 128
    n_envs: int = 8
    rollout_steps: int = 8
    updates_per_iter: int = 8
    noise_sigma: float = 0.2
    warmup: int = 1000
    quant: QuantConfig = QuantConfig.none()
    actor_backend: str = "fp32"
    kernel_backend: str = "auto"
    calib_batch: int = 0
    replay: str = "uniform"
    priority_exponent: float = 0.6
    is_beta: float = 0.4
    is_beta_anneal_updates: int = 4000


class DDPGExtras(NamedTuple):
    """The critic's params, both target nets, the critic's Adam state,
    the replay and the learner-update count (0-d int32; it moves only
    once warmup is over)."""

    critic_params: Any
    target_actor: Any
    target_critic: Any
    critic_opt: AdamState
    replay: Any
    updates: torch.Tensor


class DDPGNets(NamedTuple):
    """The actor (obs -> ``action_dim`` pre-``tanh`` outputs) and the
    critic (flat obs and action -> Q)."""

    actor: Network
    critic: Network


def make_nets(env: Env, hidden=(64, 64), device=None) -> DDPGNets:
    """The actor and critic MLPs of ``env``, both of widths ``hidden``."""
    obs_dim = int(np.prod(env.spec.obs_shape))
    a_dim = env.spec.action_dim
    return DDPGNets(
        make_network(env.spec.obs_shape, a_dim, hidden=hidden,
                     device=device),
        make_network((obs_dim + a_dim,), 1, hidden=hidden, device=device))


def init(generator: torch.Generator, env: Env, nets: DDPGNets,
         cfg: DDPGConfig) -> common.TrainState:
    """A fresh train state: the actor's then the critic's params from the
    CPU ``generator``, zero Adam moments for each, target nets that are
    separate copies, and an empty float-action replay (a sum-tree one
    for prioritized replay)."""
    actor_params = nets.actor.init(generator)
    critic_params = nets.critic.init(generator)
    device = next(t for _, t in tree_tensors(actor_params)).device
    init_replay = rb.per_init if rb.use_prioritized(
        cfg.replay, cfg.priority_exponent) else rb.replay_init
    zero = torch.zeros((), dtype=torch.int32, device=device)
    return common.TrainState(
        params=actor_params,
        opt=adam_init(actor_params, AdamConfig(lr=cfg.actor_lr)),
        observers={}, step=zero,
        extras=DDPGExtras(
            critic_params=critic_params,
            target_actor=tree_map(torch.clone, actor_params),
            target_critic=tree_map(torch.clone, critic_params),
            critic_opt=adam_init(critic_params, AdamConfig(lr=cfg.critic_lr)),
            replay=init_replay(cfg.buffer_size, env.spec.obs_shape,
                               action_shape=(env.spec.action_dim,),
                               action_dtype=torch.float32, device=device),
            updates=zero.clone()))


def _actor_out(nets: DDPGNets, cfg: DDPGConfig, params, obs, observers,
               step):
    """``tanh`` of the actor under the QAT context (sites ``actor/...``),
    and the observers that forward leaves behind."""
    base = common.make_ctx(cfg.quant, observers, step)
    out = nets.actor.apply(params, obs, ctx=common.PrefixCtx(base, "actor/"))
    return torch.tanh(out), base.merged_collection()


def make_behaviour_policy(env: Env, nets: DDPGNets, cfg: DDPGConfig):
    """``build(params, observers, step, qparams=None) -> policy``.

    ``policy(params, obs, generator) -> (action, mu)``: Gaussian noise of
    ``noise_sigma`` (drawn on the generator's device) on ``mu``, clipped
    to [-1, 1] and scaled by ``action_scale``.  With a quantized
    ``actor_backend`` ``mu`` is ``tanh`` of the packed actor, packed once
    per build unless a (possibly calibrated) ``qparams`` cache is handed
    in; else the fp32 actor under the QAT context.
    """
    common.check_config(cfg)
    scale = env.spec.action_scale
    quantized = actorq.is_quantized(cfg.actor_backend)

    def build(params, observers, step, qparams=None):
        """The exploration policy of ``params``."""
        if quantized and qparams is None:
            qparams = actorq.pack_actor_params(
                params, actorq.backend_bits(cfg.actor_backend))

        def policy(_params, obs, generator):
            """Noisy, clipped, scaled actions and the mu they came from."""
            if quantized:
                a = torch.tanh(actorq.quantized_apply(qparams, obs))
            else:
                a = _actor_out(nets, cfg, params, obs, observers, step)[0]
            noise = cfg.noise_sigma * torch.randn(
                a.shape, generator=generator, device=generator.device)
            return torch.clamp(a + noise.to(a.device), -1.0, 1.0) * scale, a
        return policy
    return build


def make_update(env: Env, nets: DDPGNets, cfg: DDPGConfig):
    """``update(state, batch, replay_size, weights=None, reduce=None) ->
    (state, (loss, td_abs))``.

    One critic step, then one actor step, on an already-sampled batch.
    The critic regresses ``Q(obs, action)`` on ``reward + gamma * (1 -
    done) * Q'(next_obs, tanh(actor'(next_obs)))`` (the target actor's
    unscaled output, as the reference's); ``weights`` (prioritized
    replay's IS weights) scale each transition's squared TD error.  The
    actor maximises the new critic's ``Q(obs, tanh(actor(obs)) *
    action_scale)``, an unweighted mean, under the observers the critic
    step left.  Both Adam states, the observers and ``step`` always
    advance; the params and the update count only once ``replay_size >=
    warmup``; both targets then move ``tau`` toward the (gated) params.
    ``loss`` is the sum of both losses, ``td_abs`` the critic's
    per-transition ``|td|`` (the rank's own: priorities stay per shard);
    both stay on the device.  ``reduce`` (a mesh axis's ``mean``,
    ``rl.distributed.Axis``; ``None`` is the identity) averages over the
    ranks, before each Adam step, the critic's gradients, loss and
    observers in one call and the actor's in another, as the reference's
    two ``reduce`` steps; ``replay_size`` is then summed over the ranks.
    """
    a_cfg = AdamConfig(lr=cfg.actor_lr)
    c_cfg = AdamConfig(lr=cfg.critic_lr)
    obs_nd = len(env.spec.obs_shape)
    scale = env.spec.action_scale

    def critic_out(params, obs, action, observers, step):
        base = common.make_ctx(cfg.quant, observers, step)
        x = torch.cat([obs.reshape(tuple(obs.shape[:obs.dim() - obs_nd])
                                   + (-1,)), action], dim=-1)
        q = nets.critic.apply(params, x,
                              ctx=common.PrefixCtx(base, "critic/"))
        return q[..., 0], base.merged_collection()

    def update(state: common.TrainState, batch: rb.Transition,
               replay_size: torch.Tensor, weights=None, reduce=None):
        ex = state.extras
        with torch.no_grad():
            next_a, _ = _actor_out(nets, cfg, ex.target_actor,
                                   batch.next_obs, state.observers,
                                   state.step)
            q_next, _ = critic_out(ex.target_critic, batch.next_obs, next_a,
                                   state.observers, state.step)
            target = batch.reward + cfg.gamma * (1 - batch.done) * q_next
        with torch.enable_grad():
            leaves = common.grad_leaves(ex.critic_params)
            q, new_coll = critic_out(leaves, batch.obs, batch.action,
                                     state.observers, state.step)
            td = q - target
            if weights is None:
                closs = torch.mean(torch.square(td))
            else:
                closs = torch.mean(weights * torch.square(td))
            cgrads = common.tree_grad(closs, leaves)
        closs = closs.detach()
        if reduce is not None:
            cgrads, closs, new_coll = reduce((cgrads, closs, new_coll))
        critic_params, critic_opt, _ = adam_update(
            cgrads, ex.critic_opt, ex.critic_params, c_cfg)

        with torch.enable_grad():
            leaves = common.grad_leaves(state.params)
            a, new_coll2 = _actor_out(nets, cfg, leaves, batch.obs, new_coll,
                                      state.step)
            q_a, _ = critic_out(critic_params, batch.obs, a * scale,
                                new_coll, state.step)
            aloss = -torch.mean(q_a)
            agrads = common.tree_grad(aloss, leaves)
        aloss = aloss.detach()
        if reduce is not None:
            agrads, aloss, new_coll2 = reduce((agrads, aloss, new_coll2))
        actor_params, actor_opt, _ = adam_update(agrads, state.opt,
                                                 state.params, a_cfg)

        warm = replay_size >= cfg.warmup
        actor_params = tree_map(lambda n, o: torch.where(warm, n, o),
                                actor_params, state.params)
        critic_params = tree_map(lambda n, o: torch.where(warm, n, o),
                                 critic_params, ex.critic_params)
        state = common.TrainState(
            params=actor_params, opt=actor_opt, observers=new_coll2,
            step=state.step + 1,
            extras=DDPGExtras(
                critic_params=critic_params,
                target_actor=common.soft_update(ex.target_actor,
                                                actor_params, cfg.tau),
                target_critic=common.soft_update(ex.target_critic,
                                                 critic_params, cfg.tau),
                critic_opt=critic_opt, replay=ex.replay,
                updates=torch.where(warm, ex.updates + 1, ex.updates)))
        return state, (closs + aloss, td.detach().abs())

    return update


def make_iteration(env: Env, nets: DDPGNets, cfg: DDPGConfig, device=None):
    """``(iteration, act_fn, benv)`` of the fused driver.

    ``iteration(state, env_state, obs, generator) -> (state, env_state,
    obs, metrics)``: one rollout of ``rollout_steps`` steps over
    ``n_envs`` envs with the exploration policy (a cache calibrated on
    the live observations, and so kernel B2, when ``calib_batch > 0``
    with a quantized backend), the replay write, then
    ``updates_per_iter`` sampled updates.  ``metrics`` (loss, reward per
    finished episode) stay on the device.  ``act_fn(params, obs,
    observers=None, step=1 << 30)`` is ``tanh(actor) * action_scale``
    under a QAT context with the sites unprefixed, as the reference's
    (so a QAT run's evaluations find no trained observer).
    ``device=None`` is ``cuda``.
    """
    common.check_config(cfg)
    use_per = rb.use_prioritized(cfg.replay, cfg.priority_exponent)
    resolve_device(device)
    benv = batched_env(env, cfg.n_envs)
    build_policy = make_behaviour_policy(env, nets, cfg)
    update = make_update(env, nets, cfg)
    calibrated = actorq.is_quantized(cfg.actor_backend) and cfg.calib_batch
    scale = env.spec.action_scale

    def iteration(state: common.TrainState, env_state, obs,
                  generator: torch.Generator):
        """One rollout, the replay write and the learner updates."""
        qparams = None
        if calibrated:
            qparams = actorq.make_actor_cache(
                state.params, cfg.actor_backend,
                calib_obs=actorq.calib_slice(obs, cfg.calib_batch))
        policy = build_policy(state.params, state.observers, state.step,
                              qparams=qparams)
        env_state, obs, traj = rollout(benv, policy, state.params,
                                       env_state, obs, generator,
                                       cfg.rollout_steps)

        def flat(x):
            return x.reshape((-1,) + tuple(x.shape[2:]))
        add = rb.per_add if use_per else rb.replay_add_batch
        replay = add(state.extras.replay, rb.Transition(
            flat(traj.obs), flat(traj.action), flat(traj.reward),
            flat(traj.done), flat(traj.next_obs)))
        state = state._replace(extras=state.extras._replace(replay=replay))
        losses = []
        for _ in range(cfg.updates_per_iter):
            if use_per:
                state, loss = common.per_learner_step(state, generator, cfg,
                                                      update)
            else:
                batch = rb.replay_sample(state.extras.replay, generator,
                                         cfg.batch_size)
                state, (loss, _) = update(state, batch,
                                          state.extras.replay.size)
            losses.append(loss)
        metrics = {"loss": torch.mean(torch.stack(losses)),
                   "reward": torch.sum(traj.reward) / torch.clamp(
                       torch.sum(traj.done), min=1.0)}
        return state, env_state, obs, metrics

    def act_fn(params, obs, observers=None, step=1 << 30):
        """Deterministic actions: ``tanh(actor(obs)) * action_scale``."""
        ctx = common.make_ctx(cfg.quant, observers or {},
                              torch.as_tensor(step, device=obs.device))
        return torch.tanh(nets.actor.apply(params, obs, ctx=ctx)) * scale

    return iteration, act_fn, benv
