"""DQN (Mnih et al. 2013) with a target network and uniform or
prioritized replay, QAT-instrumented, with the ActorQ actors.

Counterpart of ``repro/rl/dqn.py``.  ``DQNConfig`` keeps the reference's
fields and defaults.

* ``make_behaviour_policy`` -- the epsilon-greedy policy a rollout
  collects experience with: the fp32 network under the run's QAT context
  (observing, never updating the observers), the packed int8/int4 MLP
  actor (kernels B1 / B2 on the card), or -- for a sequence policy with a
  quantized backend -- the cached stepper on the per-env int8 KV cache
  (an ``env.StatefulPolicy``, kernel B3).
* ``make_td_update`` -- one fp32 learner step on a sampled batch: Huber
  TD loss under the QAT context (every fake-quant site is kernel B5 on
  the card), ``torch.autograd`` gradients, Adam.  The warmup gate and the
  target sync are ``torch.where`` on device tensors, so an update never
  waits on the host.
* ``make_iteration`` -- rollout, replay write, ``updates_per_iter`` TD
  updates; and the deterministic ``act_fn``.

All random draws come from one ``torch.Generator`` on the data's device,
in turn (the reference splits keys).  ``replay="prioritized"`` (with
``priority_exponent > 0``) keeps a sum-tree replay: each update samples
in proportion to the priorities, weights its loss by the IS weights and
pushes its ``|td|`` back (``common.per_learner_step``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.core.ptq import tree_map, tree_tensors
from repro_torch.core.qconfig import QuantConfig
from repro_torch.device import resolve_device
from repro_torch.optim.adam import AdamConfig, adam_init, adam_update
from repro_torch.rl import actorq
from repro_torch.rl import buffer as rb
from repro_torch.rl import common
from repro_torch.rl.env import Env, StatefulPolicy, batched_env, rollout
from repro_torch.rl.networks import Network


@dataclasses.dataclass(frozen=True)
class DQNConfig:
    """DQN hyperparameters (the reference's fields and defaults).

    ``actor_backend`` picks the behaviour policy's actor: ``"fp32"``, or
    the packed ``"int8"`` / ``"int4"`` cache.  ``calib_batch > 0`` (with a
    quantized backend) calibrates static activation params from that
    many live observations at every cache refresh, so the rollout runs
    the fused MLP kernel.  The port dispatches its kernels by device, so
    ``kernel_backend`` takes only ``"auto"``.
    """

    lr: float = 1e-3
    gamma: float = 0.99
    buffer_size: int = 10_000
    batch_size: int = 64
    n_envs: int = 8
    rollout_steps: int = 16       # env steps per iteration (per env)
    updates_per_iter: int = 8
    target_update_every: int = 100  # in gradient updates
    eps_start: float = 1.0
    eps_end: float = 0.01
    eps_decay_updates: int = 4000
    warmup: int = 500             # transitions before learning
    quant: QuantConfig = QuantConfig.none()
    actor_backend: str = "fp32"
    kernel_backend: str = "auto"
    calib_batch: int = 0
    replay: str = "uniform"
    priority_exponent: float = 0.6
    is_beta: float = 0.4
    is_beta_anneal_updates: int = 4000


class DQNExtras(NamedTuple):
    """Target params, the replay buffer and the learner-update count
    (0-d int32; it moves only once warmup is over)."""

    target_params: Any
    replay: rb.ReplayState
    updates: torch.Tensor


def init(generator: torch.Generator, env: Env, net: Network,
         cfg: DQNConfig) -> common.TrainState:
    """A fresh train state: params from the CPU ``generator`` (on the
    network's device), zero Adam moments, an empty replay (a sum-tree one
    for prioritized replay), and target params that are a separate copy
    of the params."""
    params = net.init(generator)
    device = next(t for _, t in tree_tensors(params)).device
    init_replay = rb.per_init if rb.use_prioritized(
        cfg.replay, cfg.priority_exponent) else rb.replay_init
    zero = torch.zeros((), dtype=torch.int32, device=device)
    return common.TrainState(
        params=params, opt=adam_init(params, AdamConfig(lr=cfg.lr)),
        observers={}, step=zero,
        extras=DQNExtras(
            target_params=tree_map(torch.clone, params),
            replay=init_replay(cfg.buffer_size, env.spec.obs_shape,
                               device=device),
            updates=zero.clone()))


def _q_values(net: Network, cfg: DQNConfig, params, obs, observers, step):
    """Q-values of ``obs`` under the run's QAT context, and the observers
    that forward leaves behind."""
    ctx = common.make_ctx(cfg.quant, observers, step)
    q = net.apply(params, obs, ctx=ctx)
    return q, ctx.merged_collection()


def make_behaviour_policy(env: Env, net: Network, cfg: DQNConfig):
    """``build(params, observers, step, updates, qparams=None) -> policy``.

    ``updates`` (a tensor) sets epsilon on the reference's linear
    schedule; ``observers`` and ``step`` are the run's QAT state (the
    fp32 actor's forward observes and fake-quantizes as the learner's
    does, and its observer updates are dropped).  A quantized
    ``actor_backend`` packs ``params`` once per build, unless a packed
    (possibly calibrated) ``qparams`` cache is handed in.  The policy is
    ``policy(params, obs, generator) -> (action, q)``, or, for a sequence
    network with a quantized backend, a ``StatefulPolicy`` whose Q-values
    come from ``actorq.quantized_seq_step`` over the per-env cache that
    ``actorq.maybe_attach_seq_state`` carries in the env state.
    Exploration draws on the generator's device (on the card, a CUDA
    generator keeps the step free of host syncs).
    """
    common.check_config(cfg)
    seq_cfg = getattr(net, "seq_cfg", None)
    quantized = actorq.is_quantized(cfg.actor_backend)
    n_actions = env.spec.n_actions

    def build(params, observers, step, updates: torch.Tensor,
              qparams=None):
        """The behaviour policy of ``params`` at ``updates`` updates."""
        eps = common.linear_epsilon(updates, cfg.eps_start, cfg.eps_end,
                                    cfg.eps_decay_updates)
        if quantized and qparams is None:
            qparams = actorq.pack_actor_params(
                params, actorq.backend_bits(cfg.actor_backend))

        def select(q, generator):
            greedy = torch.argmax(q, dim=-1)
            gdev = generator.device
            rand = torch.randint(0, n_actions, greedy.shape,
                                 generator=generator, device=gdev)
            explore = torch.rand(greedy.shape, generator=generator,
                                 device=gdev) < eps.to(gdev)
            action = torch.where(explore, rand, greedy.to(gdev))
            return action.to(device=q.device, dtype=torch.int32)

        if quantized and seq_cfg is not None:
            def apply(_params, obs, pstate, generator):
                """One cached decode step, then the epsilon-greedy pick."""
                q, pstate = actorq.quantized_seq_step(
                    qparams, obs[..., -1, :], pstate,
                    context=seq_cfg.context)
                return select(q, generator), pstate, q
            return StatefulPolicy(apply)

        def policy(_params, obs, generator):
            """Q-values of ``obs``, then the epsilon-greedy pick."""
            if quantized:
                q = actorq.quantized_apply(qparams, obs)
            else:
                q = _q_values(net, cfg, params, obs, observers, step)[0]
            return select(q, generator), q
        return policy
    return build


def make_td_update(env: Env, net: Network, cfg: DQNConfig):
    """``td_update(state, batch, replay_size, weights=None, reduce=None)
    -> (state, (loss, td_abs))``.

    One fp32 learner step on an already-sampled batch, as the reference's.
    ``weights`` (prioritized replay's IS weights) scale each transition's
    Huber loss; ``None`` keeps the plain mean.  ``reduce`` (a mesh axis's
    ``mean``, ``rl.distributed.Axis``) averages the gradients, the loss
    and the new observers over the ranks, in one call, before the Adam
    step; ``None`` is the identity.  ``replay_size`` is then the replay's
    size summed over the ranks, so every rank passes the warmup gate
    together.  ``td_abs`` is the per-transition ``|td|``, the rank's own
    (priorities stay per shard).  The
    online forward runs under autograd and leaves the observers' new
    state; the target forward reads the same observers and drops its
    updates.  Adam's state, the observers and ``step`` always advance;
    the params, and the update count, only once ``replay_size >=
    warmup``; the target takes the new params every
    ``target_update_every`` updates.  ``loss`` and ``td_abs`` stay on the
    device.
    """
    adam_cfg = AdamConfig(lr=cfg.lr)

    def td_update(state: common.TrainState, batch: rb.Transition,
                  replay_size: torch.Tensor, weights=None, reduce=None
                  ) -> Tuple[common.TrainState, Tuple[torch.Tensor,
                                                      torch.Tensor]]:
        with torch.enable_grad():
            leaves = common.grad_leaves(state.params)
            q, new_coll = _q_values(net, cfg, leaves, batch.obs,
                                    state.observers, state.step)
            q_sel = torch.gather(q, 1, batch.action[:, None].to(
                torch.int64))[:, 0]
            with torch.no_grad():
                q_next, _ = _q_values(net, cfg, state.extras.target_params,
                                      batch.next_obs, state.observers,
                                      state.step)
                target = batch.reward + cfg.gamma * (1 - batch.done) \
                    * torch.amax(q_next, dim=-1)
            td = q_sel - target
            if weights is None:
                loss = torch.mean(common.huber(td))
            else:
                loss = torch.mean(weights * common.huber(td))
            grads = common.tree_grad(loss, leaves)
        loss = loss.detach()
        if reduce is not None:
            grads, loss, new_coll = reduce((grads, loss, new_coll))
        new_params, new_opt, _ = adam_update(grads, state.opt, state.params,
                                             adam_cfg)
        updates = state.extras.updates + 1
        do_sync = (updates % cfg.target_update_every) == 0
        target_p = tree_map(lambda t, o: torch.where(do_sync, o, t),
                            state.extras.target_params, new_params)
        warm = replay_size >= cfg.warmup
        new_params = tree_map(lambda n, o: torch.where(warm, n, o),
                              new_params, state.params)
        state = common.TrainState(
            params=new_params, opt=new_opt, observers=new_coll,
            step=state.step + 1,
            extras=DQNExtras(target_p, state.extras.replay,
                             torch.where(warm, updates,
                                         state.extras.updates)))
        return state, (loss, td.detach().abs())

    return td_update


def make_iteration(env: Env, net: Network, cfg: DQNConfig, device=None):
    """``(iteration, act_fn, benv)`` of the fused driver.

    ``iteration(state, env_state, obs, generator) -> (state, env_state,
    obs, metrics)``: one rollout of ``rollout_steps`` steps over
    ``n_envs`` envs with the behaviour policy (a calibrated cache, and
    so kernel B2, when ``calib_batch > 0`` with a quantized backend),
    the replay write, then ``updates_per_iter`` sampled TD updates
    (prioritized ones through ``common.per_learner_step``).
    ``metrics`` (loss, reward per finished episode, the mean variance of
    the softmax over Q) stay on the device.  ``act_fn(params, obs,
    observers=None, step=1 << 30)`` is the greedy policy under the QAT
    context.  ``benv`` is the batched env the iteration steps; its
    ``reset(generator, device)`` starts a run.  ``device=None`` is
    ``cuda``.
    """
    common.check_config(cfg)
    use_per = rb.use_prioritized(cfg.replay, cfg.priority_exponent)
    device = resolve_device(device)
    benv = actorq.maybe_attach_seq_state(
        batched_env(env, cfg.n_envs), net, cfg.actor_backend, cfg.n_envs,
        device)
    build_policy = make_behaviour_policy(env, net, cfg)
    td_update = make_td_update(env, net, cfg)
    calibrated = actorq.is_quantized(cfg.actor_backend) and cfg.calib_batch

    def iteration(state: common.TrainState, env_state, obs,
                  generator: torch.Generator):
        """One rollout, the replay write and the TD updates."""
        qparams = None
        if calibrated:
            qparams = actorq.make_actor_cache(
                state.params, cfg.actor_backend,
                calib_obs=actorq.calib_slice(obs, cfg.calib_batch))
        policy = build_policy(state.params, state.observers, state.step,
                              state.extras.updates, qparams=qparams)
        env_state, obs, traj = rollout(benv, policy, state.params,
                                       env_state, obs, generator,
                                       cfg.rollout_steps)

        def flat(x):
            return x.reshape((-1,) + tuple(x.shape[2:]))
        add = rb.per_add if use_per else rb.replay_add_batch
        replay = add(
            state.extras.replay,
            rb.Transition(flat(traj.obs), flat(traj.action),
                          flat(traj.reward), flat(traj.done),
                          flat(traj.next_obs)))
        state = state._replace(extras=state.extras._replace(replay=replay))
        losses = []
        for _ in range(cfg.updates_per_iter):
            if use_per:
                state, loss = common.per_learner_step(state, generator, cfg,
                                                      td_update)
            else:
                batch = rb.replay_sample(state.extras.replay, generator,
                                         cfg.batch_size)
                state, (loss, _) = td_update(state, batch,
                                             state.extras.replay.size)
            losses.append(loss)
        metrics = {
            "loss": torch.mean(torch.stack(losses)),
            "reward": torch.sum(traj.reward) / torch.clamp(
                torch.sum(traj.done), min=1.0),
            "mean_q_var": torch.var(torch.softmax(traj.logits_or_value,
                                                  dim=-1),
                                    dim=-1, correction=0).mean()}
        return state, env_state, obs, metrics

    def act_fn(params, obs, observers=None, step=1 << 30):
        """Greedy actions (int32) under the QAT context at ``step``."""
        step = torch.as_tensor(step, device=obs.device)
        q = _q_values(net, cfg, params, obs, observers or {}, step)[0]
        return torch.argmax(q, dim=-1).to(torch.int32)

    return iteration, act_fn, benv
