"""The training loop and the QuaRL pipelines (paper Algorithms 1 and 2).

Counterpart of ``repro/rl/loops.py`` for ``algo="dqn"`` and the fused
topology:

* ``train`` -- the fused driver: one learner, ``n_envs`` batched envs,
  rollouts by the behaviour policy (fp32 under the QAT context, or the
  ActorQ int8/int4 actor), uniform replay, the TD updates, and an
  evaluation every ``record_every`` iterations (through the packed actor
  when the backend is quantized -- calibrated, and so kernel B2, with
  ``calib_batch`` -- else the greedy fp32 policy under the QAT context);
* ``make_scan_iteration`` -- the ``steps_per_call`` chunk: a host loop
  over that many iterations, with the metrics kept on the device until
  the chunk ends.  Chunks are clipped to ``record_every`` boundaries, so
  any ``steps_per_call`` gives the per-step driver's run bit for bit;
* ``eval_policy`` / ``quarl_ptq`` / ``quarl_qat`` -- Eval(Q(M)) and the
  two studies, with the paper's relative error E_%.

A run's randomness comes from ``torch.Generator``s seeded from ``seed``:
one on the CPU for the params, and on the run's device one for env
resets, one for the loop (exploration and replay draws, in turn) and one
for evaluations.  ``device=None`` is ``cuda``.

Not ported yet, and raising ``NotImplementedError`` naming the ROADMAP
queue A item: the other algorithms (item 8), the actor-learner and async
topologies and prioritized replay (item 7), checkpointing and resume
(item 9), and the resilience hooks (item 11).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.core import fake_quant
from repro_torch.core import metrics as metrics_lib
from repro_torch.core.qconfig import QuantConfig, QuantMode
from repro_torch.device import resolve_device
from repro_torch.rl import actorq, common, dqn
from repro_torch.rl import buffer as rb
from repro_torch.rl.env import Env, evaluate
from repro_torch.rl.envs import make as make_env
from repro_torch.rl.networks import make_network

ALGOS = ("dqn", "a2c", "ppo", "ddpg")
TOPOLOGIES = ("fused", "actor-learner", "async")


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP queue "
                               f"A, item {item})")


def _bootstrap_observers(env: Env, net, state: common.TrainState,
                         quant: QuantConfig):
    """Every QAT observer slot, fresh, found by one forward on zeros."""
    device = state.step.device
    obs0 = torch.zeros((2,) + tuple(env.spec.obs_shape), device=device)
    return fake_quant.discover_observers(
        quant, lambda rec: net.apply(state.params, obs0, ctx=rec))


@dataclasses.dataclass
class TrainResult:
    """What ``train`` hands back: the final ``state``, the deterministic
    ``act_fn(params, obs, observers, step)``, the ``env``, the recorded
    eval ``rewards`` and ``action_variances``, the wall time, the
    resolved config and network, the run's ``device``, and
    ``eval_steps``, the batched env steps its evaluations ran (each one
    forward of the eval policy)."""

    state: common.TrainState
    act_fn: Callable
    env: Env
    rewards: List[float]
    action_variances: List[float]
    wall_time_s: float
    algo_cfg: Any
    net: Any
    device: torch.device
    eval_steps: int = 0


def make_scan_iteration(iteration: Callable, steps_per_call: int):
    """``chunk(state, env_state, obs, generator) -> (state, env_state,
    obs, metrics)``: ``steps_per_call`` iterations in a host loop, with
    each metric stacked to ``(steps_per_call,)`` on the device."""
    def chunk(state, env_state, obs, generator):
        """Run the chunk's iterations one after another."""
        per = []
        for _ in range(steps_per_call):
            state, env_state, obs, m = iteration(state, env_state, obs,
                                                 generator)
            per.append(m)
        metrics = {k: torch.stack([m[k] for m in per]) for k in per[0]}
        return state, env_state, obs, metrics
    return chunk


def _check_supported(algo, topology, num_actors, sync_every, mesh,
                     async_barrier, replay, priority_exponent,
                     checkpoint_dir, checkpoint_every, resume, resilience):
    if algo not in ALGOS:
        raise ValueError(f"algo must be one of {ALGOS}, got {algo!r}")
    if algo != "dqn":
        raise _not_ported(f"algo={algo!r}", 8)
    if topology not in TOPOLOGIES:
        raise ValueError(f"topology must be one of {TOPOLOGIES}, got "
                         f"{topology!r}")
    if topology != "fused" or async_barrier or num_actors != 1 \
            or sync_every != 1 or mesh is not None:
        raise _not_ported("the actor-learner and async topologies", 7)
    if rb.use_prioritized(replay, priority_exponent):
        raise _not_ported("prioritized replay", 7)
    if checkpoint_dir or checkpoint_every or resume:
        raise _not_ported("checkpointing and resume", 9)
    if resilience is not None:
        raise _not_ported("the resilience hooks", 11)


def train(algo: str, env_name: str, *, iterations: int = 200,
          quant: QuantConfig = QuantConfig.none(), seed: int = 0,
          net_kwargs: Optional[Dict] = None,
          algo_overrides: Optional[Dict] = None,
          record_every: int = 10, eval_episodes: int = 8,
          steps_per_call: int = 1,
          actor_backend: str = "fp32", calib_batch: int = 0,
          topology: str = "fused", num_actors: int = 1,
          sync_every: int = 1, mesh=None, async_barrier: bool = False,
          replay: str = "uniform", priority_exponent: float = 0.6,
          is_beta: float = 0.4,
          checkpoint_dir: Optional[str] = None, checkpoint_every: int = 0,
          resume: bool = False, resilience: Any = None,
          device=None) -> TrainResult:
    """Train ``algo`` on ``env_name`` with the fused driver.

    ``steps_per_call`` iterations run per chunk (``make_scan_iteration``),
    clipped to ``record_every`` boundaries, so every value gives the same
    run.  ``actor_backend="int8"``/``"int4"`` collects rollouts and
    evaluates through the packed actor (ActorQ; the learner stays fp32);
    ``calib_batch > 0`` calibrates that cache from the live observations
    at every refresh, so both run the fused kernel.  ``quant`` is the
    learner's QAT config (``QuantConfig.qat``); its ``quant_delay``
    counts TD updates (the state's ``step``, ``updates_per_iter`` per
    iteration).  ``device=None`` is ``cuda``.
    """
    _check_supported(algo, topology, num_actors, sync_every, mesh,
                     async_barrier, replay, priority_exponent,
                     checkpoint_dir, checkpoint_every, resume, resilience)
    actorq.validate_actor_backend(actor_backend)
    device = resolve_device(device)
    env = make_env(env_name)
    overrides = dict(algo_overrides or {})
    overrides.setdefault("actor_backend", actor_backend)
    overrides.setdefault("calib_batch", calib_batch)
    overrides.setdefault("replay", replay)
    overrides.setdefault("priority_exponent", priority_exponent)
    overrides.setdefault("is_beta", is_beta)
    net = make_network(env.spec.obs_shape, env.spec.n_actions,
                       device=device, **(net_kwargs or {}))
    cfg = dataclasses.replace(dqn.DQNConfig(quant=quant), **overrides)

    def gen(offset):
        return torch.Generator(device=device).manual_seed(seed + offset)
    state = dqn.init(torch.Generator().manual_seed(seed), env, net, cfg)
    if quant.is_qat:
        state = state._replace(
            observers=_bootstrap_observers(env, net, state, quant))
    iteration, act_fn, benv = dqn.make_iteration(env, net, cfg, device)
    env_state, obs = benv.reset(gen(1), device)
    g_run, g_eval = gen(2), gen(3)

    quantized = actorq.is_quantized(cfg.actor_backend)
    int8_act = actorq.make_act_fn(env.spec) if quantized else None
    eval_steps = [0]

    def counted(act):
        def step(p, o):
            eval_steps[0] += 1
            return act(p, o)
        return step
    q_act = counted(int8_act) if quantized else None
    det_act = counted(lambda p, o: act_fn(p[0], o, p[1], p[2]))
    chunks: Dict[int, Callable] = {}
    rewards, variances = [], []
    i = 0
    t0 = time.time()
    while i < iterations:
        next_stop = min((i // record_every + 1) * record_every, iterations)
        n = min(max(steps_per_call, 1), next_stop - i)
        if n not in chunks:
            chunks[n] = make_scan_iteration(iteration, n)
        state, env_state, obs, metrics = chunks[n](state, env_state, obs,
                                                   g_run)
        i += n
        if i % record_every == 0 or i == iterations:
            if q_act is not None:
                obs_g = obs.reshape((-1,) + tuple(env.spec.obs_shape))
                qparams = actorq.make_actor_cache(
                    state.params, cfg.actor_backend,
                    calib_obs=actorq.calib_slice(obs_g, cfg.calib_batch)
                    if cfg.calib_batch else None)
                r = evaluate(env, q_act, qparams, g_eval, eval_episodes,
                             max_steps=env.spec.max_steps, device=device)
            else:
                r = evaluate(env, det_act,
                             (state.params, state.observers, state.step),
                             g_eval, eval_episodes,
                             max_steps=env.spec.max_steps, device=device)
            rewards.append(float(r))
            variances.append(float(metrics["mean_q_var"][-1]))
    wall = time.time() - t0
    return TrainResult(state=state, act_fn=act_fn, env=env, rewards=rewards,
                       action_variances=variances, wall_time_s=wall,
                       algo_cfg=cfg, net=net, device=device,
                       eval_steps=eval_steps[0])


def eval_policy(result: TrainResult, quant: QuantConfig,
                generator: torch.Generator, episodes: int = 16, *,
                actor_backend: str = "fp32") -> float:
    """Eval(Q(M)): the (possibly quantized) policy, run greedily.

    ``actor_backend="int8"`` (or ``"int4"``, capping the width at 4 bits)
    deploys an int PTQ config of at most 8 bits through the packed actor
    (kernel B1); every other config runs the fp32 forward on
    ``common.eval_params`` (kernel B5 quantizes the weights) under the
    run's QAT context.
    """
    actorq.validate_actor_backend(actor_backend)
    env = result.env
    if (actorq.is_quantized(actor_backend)
            and quant.mode == QuantMode.PTQ_INT and quant.bits <= 8):
        bits = min(quant.bits, actorq.backend_bits(actor_backend))
        qparams = actorq.pack_actor_params(result.state.params, bits=bits)
        return float(evaluate(env, actorq.make_act_fn(env.spec), qparams,
                              generator, episodes,
                              max_steps=env.spec.max_steps,
                              device=result.device))
    params = common.eval_params(result.state.params, quant)
    st = result.state

    def act(p, o):
        return result.act_fn(p, o, st.observers, st.step)
    return float(evaluate(env, act, params, generator, episodes,
                          max_steps=env.spec.max_steps,
                          device=result.device))


@dataclasses.dataclass
class QuarlResult:
    """One row of a QuaRL PTQ/QAT study: fp32 against quantized eval
    reward for (``algo``, ``env``) at ``label``, the paper's relative
    ``error_pct``, and the study's ``extra`` values."""

    algo: str
    env: str
    label: str
    fp32_reward: float
    quant_reward: float
    error_pct: float
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)


def _eval_gen(result: TrainResult, seed: int) -> torch.Generator:
    return torch.Generator(device=result.device).manual_seed(seed)


def quarl_ptq(algo: str, env_name: str, bits_list=(8, 16), *,
              iterations: int = 200, seed: int = 0,
              net_kwargs=None, algo_overrides=None,
              eval_episodes: int = 16, steps_per_call: int = 1,
              actor_backend: str = "fp32",
              result: Optional[TrainResult] = None,
              device=None) -> List[QuarlResult]:
    """Algorithm 1 over fp16 (``16`` in ``bits_list``) and intN PTQ.

    Trains an fp32 run, unless a finished one is handed in as
    ``result``; every evaluation sees the same episodes (a generator
    seeded ``seed + 1000`` each time).  ``actor_backend="int8"`` deploys
    each intN evaluation through the packed actor.
    """
    if result is None:
        result = train(algo, env_name, iterations=iterations, seed=seed,
                       net_kwargs=net_kwargs, algo_overrides=algo_overrides,
                       steps_per_call=steps_per_call, device=device)
    fp32 = eval_policy(result, QuantConfig.none(),
                       _eval_gen(result, seed + 1000), eval_episodes)
    stats = metrics_lib.weight_distribution_stats(result.state.params)
    out = []
    for bits in bits_list:
        q = QuantConfig.ptq_fp16() if bits == 16 else QuantConfig.ptq_int(bits)
        r = eval_policy(result, q, _eval_gen(result, seed + 1000),
                        eval_episodes, actor_backend=actor_backend)
        out.append(QuarlResult(
            algo=algo, env=env_name, label=q.label(), fp32_reward=fp32,
            quant_reward=r, error_pct=metrics_lib.relative_error(fp32, r),
            extra={"weight_stats": stats}))
    return out


def quarl_qat(algo: str, env_name: str, bits: int, *, iterations: int = 200,
              quant_delay_frac: float = 0.5, seed: int = 0,
              net_kwargs=None, algo_overrides=None,
              eval_episodes: int = 16, steps_per_call: int = 1,
              actor_backend: str = "fp32", device=None) -> QuarlResult:
    """Algorithm 2: an fp32 run and a QAT run whose ranges are monitored
    for ``int(iterations * quant_delay_frac)`` TD updates (the
    reference's count: with 8 updates an iteration, quantization turns
    on an eighth of the way through that many iterations), each
    evaluated on the same episodes (seed ``seed + 2000``)."""
    delay = int(iterations * quant_delay_frac)
    quant = QuantConfig.qat(bits, quant_delay=delay)
    common_kw = dict(iterations=iterations, seed=seed,
                     net_kwargs=net_kwargs, algo_overrides=algo_overrides,
                     steps_per_call=steps_per_call, device=device)
    fp = train(algo, env_name, **common_kw)
    qt = train(algo, env_name, quant=quant, actor_backend=actor_backend,
               **common_kw)
    fp32 = eval_policy(fp, QuantConfig.none(), _eval_gen(fp, seed + 2000),
                       eval_episodes)
    q_r = eval_policy(qt, quant, _eval_gen(qt, seed + 2000), eval_episodes)
    return QuarlResult(
        algo=algo, env=env_name, label=f"qat{bits}", fp32_reward=fp32,
        quant_reward=q_r, error_pct=metrics_lib.relative_error(fp32, q_r),
        extra={"variances_fp": fp.action_variances,
               "variances_qat": qt.action_variances,
               "rewards_fp": fp.rewards, "rewards_qat": qt.rewards})
