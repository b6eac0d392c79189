"""DQN's behaviour (data-collection) policy, with the ActorQ actors.

Counterpart of ``repro/rl/dqn.py:25-58, 91-152``.  ``DQNConfig`` keeps the
reference's fields and defaults.  ``make_behaviour_policy`` builds the
epsilon-greedy policy a rollout collects experience with: the fp32
network, the packed int8/int4 MLP actor, or -- for a sequence policy with
a quantized backend -- the cached stepper on the per-env int8 KV cache
(an ``env.StatefulPolicy``).  The learner's TD update, replay and the
training loop are not ported yet (ROADMAP queue A, item 5).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.qconfig import QuantConfig, QuantMode
from repro_torch.rl import actorq
from repro_torch.rl import common
from repro_torch.rl.env import Env, StatefulPolicy
from repro_torch.rl.networks import Network


@dataclasses.dataclass(frozen=True)
class DQNConfig:
    """DQN hyperparameters (the reference's fields and defaults).

    ``actor_backend`` picks the behaviour policy's actor: ``"fp32"``, or
    the packed ``"int8"`` / ``"int4"`` cache.  The port dispatches its
    kernels by device, so ``kernel_backend`` takes only ``"auto"``.
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


def make_behaviour_policy(env: Env, net: Network, cfg: DQNConfig):
    """``build(params, updates, qparams=None) -> policy``.

    ``updates`` (a tensor) sets epsilon on the reference's linear
    schedule.  A quantized ``actor_backend`` packs ``params`` once per
    build, unless a packed ``qparams`` cache is handed in.  The policy is
    ``policy(params, obs, generator) -> (action, q)``, or, for a sequence
    network with a quantized backend, a ``StatefulPolicy`` whose Q-values
    come from ``actorq.quantized_seq_step`` over the per-env cache that
    ``actorq.maybe_attach_seq_state`` carries in the env state.
    Exploration draws on the generator's device (on the card, a CUDA
    generator keeps the step free of host syncs).
    """
    actorq.validate_actor_backend(cfg.actor_backend)
    if cfg.kernel_backend != "auto":
        raise ValueError("the port dispatches kernels by device; "
                         f"kernel_backend must be 'auto', got "
                         f"{cfg.kernel_backend!r}")
    if cfg.quant.mode != QuantMode.NONE:
        raise NotImplementedError("QAT is not ported yet (ROADMAP queue A, "
                                  "item 8)")
    seq_cfg = getattr(net, "seq_cfg", None)
    quantized = actorq.is_quantized(cfg.actor_backend)
    n_actions = env.spec.n_actions

    def build(params, updates: torch.Tensor, qparams=None):
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
            q = actorq.quantized_apply(qparams, obs) if quantized \
                else net.apply(params, obs)
            return select(q, generator), q
        return policy
    return build
