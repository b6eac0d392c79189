"""The training loops and the QuaRL pipelines (paper Algorithms 1 and 2).

Counterpart of ``repro/rl/loops.py`` for its four algorithms, ``"dqn"``,
``"ddpg"``, ``"a2c"`` and ``"ppo"``:

* ``train`` -- one learner and its actors in one of three topologies:
  ``"fused"`` (``n_envs`` batched envs stepped by the learner's own
  behaviour policy; every algorithm), ``"actor-learner"``
  (``num_actors`` actors with a sharded replay and a push every
  ``sync_every`` iterations) or ``"async"`` (actor and learner chunks on
  two CUDA streams over a double-buffered replay, a push every
  ``sync_every`` learner updates), the last two for the replay
  algorithms DQN and DDPG (``rl.actor_learner``).  Rollouts run the
  fp32 policy under the QAT context or the ActorQ int8/int4 actor; the
  replay of DQN and DDPG is uniform or prioritized; an evaluation runs
  every ``record_every`` iterations (through the packed actor when the
  backend is quantized -- calibrated, and so kernel B2, with
  ``calib_batch`` -- else the deterministic fp32 policy under the QAT
  context);
* ``make_scan_iteration`` -- the ``steps_per_call`` chunk: a host loop
  over that many iterations, with the metrics kept on the device until
  the chunk ends.  Chunks are clipped to ``record_every`` boundaries, so
  any ``steps_per_call`` gives the per-step driver's run bit for bit
  (async rounds are ``steps_per_call`` rollouts and their updates, so
  there it sets the run);
* ``eval_policy`` / ``quarl_ptq`` / ``quarl_qat`` -- Eval(Q(M)) and the
  two studies, with the paper's relative error E_%.

A run's randomness comes from ``torch.Generator``s seeded from ``seed``:
one on the CPU for the params, and on the run's device one for env
resets, one for the loop (exploration and replay draws, in turn, in every
topology) and one for evaluations.  ``device=None`` is ``cuda``.

Not ported yet, and raising ``NotImplementedError`` naming the ROADMAP
queue A item: a device mesh (item 14), checkpointing and resume (item
9), and the resilience hooks (item 11).
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
from repro_torch.rl import a2c, actor_learner, actorq, common, ddpg, dqn, \
    ppo
from repro_torch.rl import buffer as rb
from repro_torch.rl.env import Env, evaluate
from repro_torch.rl.envs import make as make_env
from repro_torch.rl.networks import make_network

ALGOS = ("dqn", "a2c", "ppo", "ddpg")
MODULES = {"dqn": dqn, "a2c": a2c, "ppo": ppo, "ddpg": ddpg}


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP queue "
                               f"A, item {item})")


def _bootstrap_observers(algo: str, env: Env, net,
                         state: common.TrainState, quant: QuantConfig):
    """Every QAT observer slot, fresh, found by one forward on zeros
    (DDPG's actor under ``actor/`` and its critic, on the actor's
    actions, under ``critic/``)."""
    device = state.step.device
    obs0 = torch.zeros((2,) + tuple(env.spec.obs_shape), device=device)
    if algo == "ddpg":
        def trace(rec):
            a = torch.tanh(net.actor.apply(
                state.params, obs0, ctx=common.PrefixCtx(rec, "actor/")))
            net.critic.apply(state.extras.critic_params,
                             torch.cat([obs0.reshape(2, -1), a], dim=-1),
                             ctx=common.PrefixCtx(rec, "critic/"))
    else:
        def trace(rec):
            net.apply(state.params, obs0, ctx=rec)
    return fake_quant.discover_observers(quant, trace)


@dataclasses.dataclass
class TrainResult:
    """What ``train`` hands back: the final (learner) ``state``, the
    deterministic ``act_fn(params, obs, observers, step)``, the ``env``,
    the recorded eval ``rewards`` and ``action_variances``, the wall time,
    the resolved config and network, the run's ``device``, ``eval_steps``
    (the batched env steps its evaluations ran, each one forward of the
    eval policy), and, for the actor-learner topologies, ``divergences``
    (per-actor behaviour-vs-learner head gaps at true pushes: one a record
    point for ``"actor-learner"``, one a push for ``"async"``) and, for
    ``"async"``, ``actor_lags`` (the learner updates each retired snapshot
    served for, at least ``sync_every``)."""

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
    divergences: List[List[float]] = dataclasses.field(default_factory=list)
    actor_lags: List[int] = dataclasses.field(default_factory=list)


def make_scan_iteration(iteration: Callable, steps_per_call: int):
    """``chunk(state, env_state, obs, generator) -> (state, env_state,
    obs, metrics)``: ``steps_per_call`` iterations in a host loop, with
    each metric stacked to ``(steps_per_call, ...)`` on the device."""
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
                     async_barrier, quant, replay, priority_exponent,
                     checkpoint_dir, checkpoint_every, resume, resilience):
    if algo not in ALGOS:
        raise ValueError(f"algo must be one of {ALGOS}, got {algo!r}")
    actor_learner.validate_topology(topology)
    rb.use_prioritized(replay, priority_exponent)
    if topology != "fused" and algo not in actor_learner.ALGOS:
        raise ValueError(f"topology={topology!r} needs a replay algorithm "
                         f"{actor_learner.ALGOS}, got {algo!r}")
    if async_barrier and topology != "async":
        raise ValueError("async_barrier is an async-topology knob: pass "
                         "topology='async'")
    if topology == "fused" and (num_actors != 1 or sync_every != 1
                                or mesh is not None):
        raise ValueError("num_actors/sync_every/mesh are actor-learner "
                         "knobs: pass topology='actor-learner' or 'async' "
                         "(the fused driver would ignore them)")
    if topology != "fused" and quant.is_qat:
        raise ValueError(f"the {topology} topology does not support QAT "
                         f"(the learner trains fp32; use PTQ eval)")
    if mesh is not None:
        raise _not_ported("a device mesh over the actor axis", 14)
    if checkpoint_dir or checkpoint_every or resume:
        raise _not_ported("checkpointing and resume", 9)
    if resilience is not None:
        raise _not_ported("the resilience hooks", 11)


def _build(algo: str, env: Env, quant: QuantConfig, net_kwargs: Dict,
           overrides: Dict, device):
    """``(net, cfg)`` of ``algo`` on ``env``: DDPG's actor and critic
    (``ddpg.DDPGNets``), else one network whose head is ``n_actions``
    wide, one more for the value of A2C and PPO."""
    if algo == "ddpg":
        if not env.spec.continuous:
            raise ValueError(f"DDPG needs a continuous env, got "
                             f"{env.spec.name!r}")
        nets = ddpg.make_nets(env, device=device, **net_kwargs)
        return nets, dataclasses.replace(ddpg.DDPGConfig(quant=quant),
                                         **overrides)
    out_dim = env.spec.n_actions + (1 if algo in ("a2c", "ppo") else 0)
    net = make_network(env.spec.obs_shape, out_dim, device=device,
                       **net_kwargs)
    config = {"dqn": dqn.DQNConfig, "a2c": a2c.A2CConfig,
              "ppo": ppo.PPOConfig}[algo]
    return net, dataclasses.replace(config(quant=quant), **overrides)


def _evaluator(env: Env, cfg, act_fn, g_eval: torch.Generator,
               eval_episodes: int, device, eval_steps: List[int]):
    """``evaluate_at(params, observers, step, obs) -> float``: the eval
    reward of the learner's params -- through the packed actor when the
    backend is quantized (calibrated on the live ``obs`` with
    ``calib_batch``), else the greedy fp32 policy under the QAT context.
    Each batched eval step adds one to ``eval_steps[0]``."""
    quantized = actorq.is_quantized(cfg.actor_backend)

    def counted(act):
        def step(p, o):
            eval_steps[0] += 1
            return act(p, o)
        return step
    q_act = counted(actorq.make_act_fn(env.spec)) if quantized else None
    det_act = counted(lambda p, o: act_fn(p[0], o, p[1], p[2]))

    def evaluate_at(params, observers, step, obs) -> float:
        if q_act is not None:
            obs_g = obs.reshape((-1,) + tuple(env.spec.obs_shape))
            qparams = actorq.make_actor_cache(
                params, cfg.actor_backend,
                calib_obs=actorq.calib_slice(obs_g, cfg.calib_batch)
                if cfg.calib_batch else None)
            r = evaluate(env, q_act, qparams, g_eval, eval_episodes,
                         max_steps=env.spec.max_steps, device=device)
        else:
            r = evaluate(env, det_act, (params, observers, step), g_eval,
                         eval_episodes, max_steps=env.spec.max_steps,
                         device=device)
        return float(r)
    return evaluate_at


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
    """Train ``algo`` on ``env_name``.

    ``steps_per_call`` iterations run per chunk (``make_scan_iteration``),
    clipped to ``record_every`` boundaries, so every value gives the same
    run in the fused and actor-learner topologies.  ``actor_backend=
    "int8"``/``"int4"`` collects rollouts and evaluates through the packed
    actor (ActorQ; the learner stays fp32); ``calib_batch > 0`` calibrates
    that cache from the live observations at every refresh, so both run
    the fused kernel.  ``quant`` is the learner's QAT config
    (``QuantConfig.qat``, fused topology only); its ``quant_delay`` counts
    the state's ``step``: learner updates for DQN and DDPG
    (``updates_per_iter`` an iteration), iterations for A2C and PPO.
    ``replay="prioritized"`` (DQN and DDPG) samples by priority (a
    sum-tree a shard), ``priority_exponent=0`` being bitwise uniform.

    ``topology="actor-learner"`` runs ``num_actors`` actors pushed every
    ``sync_every`` iterations; ``topology="async"`` runs a round of
    ``steps_per_call`` rollouts and ``steps_per_call * updates_per_iter``
    learner updates on two streams, pushing at the first round boundary
    ``sync_every`` learner updates after the last push.
    ``async_barrier=True`` threads one replay slot actor -> learner: with
    ``steps_per_call=1`` and ``sync_every=updates_per_iter`` the run is
    bitwise the actor-learner run with ``sync_every=1``.  ``device=None``
    is ``cuda``.
    """
    _check_supported(algo, topology, num_actors, sync_every, mesh,
                     async_barrier, quant, replay, priority_exponent,
                     checkpoint_dir, checkpoint_every, resume, resilience)
    actorq.validate_actor_backend(actor_backend)
    device = resolve_device(device)
    env = make_env(env_name)
    overrides = dict(algo_overrides or {})
    overrides.setdefault("actor_backend", actor_backend)
    overrides.setdefault("calib_batch", calib_batch)
    if algo in actor_learner.ALGOS:
        overrides.setdefault("replay", replay)
        overrides.setdefault("priority_exponent", priority_exponent)
        overrides.setdefault("is_beta", is_beta)
    elif rb.validate_replay(overrides.get("replay", replay)) != "uniform":
        raise ValueError(f"replay='prioritized' needs a replay algorithm "
                         f"{actor_learner.ALGOS}; {algo!r} is on-policy")
    net, cfg = _build(algo, env, quant, net_kwargs or {}, overrides, device)
    mod = MODULES[algo]

    def gen(offset):
        return torch.Generator(device=device).manual_seed(seed + offset)
    g_params = torch.Generator().manual_seed(seed)
    if topology == "async":
        return _train_async(algo, env, net, cfg, g_params, gen,
                            iterations=iterations,
                            record_every=record_every,
                            eval_episodes=eval_episodes,
                            steps_per_call=steps_per_call,
                            num_actors=num_actors, sync_every=sync_every,
                            barrier=async_barrier, device=device)
    if topology == "actor-learner":
        al = actor_learner.ActorLearnerConfig(num_actors=num_actors,
                                              sync_every=sync_every)
        state = actor_learner.init(g_params, env, net, algo, cfg, al)
        iteration, act_fn, benv = actor_learner.make_actor_learner(
            algo, env, net, cfg, al, device=device)
    else:
        state = mod.init(g_params, env, net, cfg)
        if quant.is_qat:
            state = state._replace(observers=_bootstrap_observers(
                algo, env, net, state, quant))
        iteration, act_fn, benv = mod.make_iteration(env, net, cfg, device)
    env_state, obs = benv.reset(gen(1), device)
    g_run = gen(2)
    eval_steps = [0]
    evaluate_at = _evaluator(env, cfg, act_fn, gen(3), eval_episodes,
                             device, eval_steps)
    chunks: Dict[int, Callable] = {}
    rewards, variances, divergences = [], [], []
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
            learner = state.learner if isinstance(
                state, actor_learner.ActorLearnerState) else state
            rewards.append(evaluate_at(learner.params, learner.observers,
                                       learner.step, obs))
            variances.append(next(
                (float(metrics[k][-1]) for k in ("action_dist_variance",
                                                 "mean_q_var")
                 if k in metrics), 0.0))
            # the first push is at iteration sync_every: a record point
            # before it would only see the init-time zeros
            if "divergence" in metrics and i >= sync_every:
                divergences.append(metrics["divergence"][-1].tolist())
    wall = time.time() - t0
    if isinstance(state, actor_learner.ActorLearnerState):
        state = state.learner
    return TrainResult(state=state, act_fn=act_fn, env=env, rewards=rewards,
                       action_variances=variances, wall_time_s=wall,
                       algo_cfg=cfg, net=net, device=device,
                       eval_steps=eval_steps[0], divergences=divergences)


def _train_async(algo: str, env: Env, net, cfg, g_params: torch.Generator,
                 gen, *,
                 iterations: int, record_every: int, eval_episodes: int,
                 steps_per_call: int, num_actors: int, sync_every: int,
                 barrier: bool, device) -> TrainResult:
    """The ``topology="async"`` driver.

    A round enqueues one actor chunk (``c`` rollouts into the write slot,
    on the actors' stream) and one learner chunk (``c *
    updates_per_iter`` updates on the read slot, on the learner's
    stream), ``c`` being ``steps_per_call`` clipped to the next record
    point, and waits on neither.  Once ``sync_every`` learner updates have
    landed since the last push, the host swaps the slots, mints the next
    snapshot (the streams join there) and enqueues the divergence, which
    stays on the device until the run ends; the retiring snapshot's lag
    is host arithmetic.  Evaluations at record points are the only host
    syncs.  ``barrier=True`` threads one slot actor -> learner and makes
    each chunk wait for the other's last one.
    """
    al = actor_learner.ActorLearnerConfig(num_actors=num_actors,
                                          sync_every=sync_every)
    progs = actor_learner.make_async_actor_learner(algo, env, net, cfg, al,
                                                   device=device)
    learner, wbuf = actor_learner.init_async(g_params, env, net, algo, cfg,
                                             al, double=not barrier)
    env_state, obs = progs.benv_global.reset(gen(1), device)
    g_run = gen(2)
    eval_steps = [0]
    evaluate_at = _evaluator(env, cfg, progs.act_fn, gen(3), eval_episodes,
                             device, eval_steps)
    streams = progs.streams
    streams.start()
    streams.share((learner, wbuf, env_state, obs))
    snap = progs.make_snapshot(learner, obs)
    rewards, variances, actor_lags, divs = [], [], [], []
    updates_since_push = total_updates = snap_minted_at = 0
    i = 0
    t0 = time.time()
    while i < iterations:
        next_stop = min((i // record_every + 1) * record_every, iterations)
        c = min(max(steps_per_call, 1), next_stop - i)
        if barrier:
            wbuf = learner.extras.replay
            streams.actors_wait_for_learner()
            streams.share(wbuf)
        env_state, obs, wbuf, _ = progs.actor_chunk(
            snap, env_state, obs, wbuf, g_run, n_chunks=c)
        if barrier:
            learner = learner._replace(
                extras=learner.extras._replace(replay=wbuf))
            streams.learner_waits_for_actors()
            streams.share(wbuf)
        learner, _ = progs.learner_chunk(
            learner, g_run, n_updates=c * cfg.updates_per_iter)
        total_updates += c * cfg.updates_per_iter
        updates_since_push += c * cfg.updates_per_iter
        i += c
        if updates_since_push >= sync_every:
            if not barrier:
                learner, wbuf = actor_learner.swap_read_slot(learner, wbuf,
                                                             streams)
            actor_lags.append(total_updates - snap_minted_at)
            snap = progs.make_snapshot(learner, obs)
            snap_minted_at = total_updates
            divs.append(progs.divergence(learner, snap, obs))
            updates_since_push = 0
        if i % record_every == 0 or i == iterations:
            streams.learner_waits_for_actors()
            streams.share(obs)
            with streams.on_learner():
                rewards.append(evaluate_at(learner.params, learner.observers,
                                           learner.step, obs))
            # neither chunk surfaces an action variance (the reference
            # records the same zeros)
            variances.append(0.0)
    streams.finish()
    wall = time.time() - t0
    return TrainResult(state=learner, act_fn=progs.act_fn, env=env,
                       rewards=rewards, action_variances=variances,
                       wall_time_s=wall, algo_cfg=cfg, net=net,
                       device=device, eval_steps=eval_steps[0],
                       divergences=[d.tolist() for d in divs],
                       actor_lags=actor_lags)


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
