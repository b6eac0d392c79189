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

**Checkpoints** (``checkpoint_dir``, ``repro_torch.checkpoint``): every
``checkpoint_every`` iterations, at the end of the chunk or round that
reaches it (cadence never clips one) and after that point's evaluation,
the background writer saves the run's state -- the train state, the env
state and observations (a sequence actor's KV caches ride in the env
state), the async snapshot and write slot -- with the states of the loop's
and the evaluator's generators, and the counters and recorded metrics in
the manifest's ``extra``.  ``resume=True`` restores the newest valid step
into a freshly built run of the same config, so the resumed run is
bitwise the uninterrupted one.

**Resilience** (``resilience``, a ``repro_torch.resilience.
ResilienceContext``): host hooks around every chunk or round --
``round_start`` before it, the learner's finite guard and the fault
injections after it, the guarded async push, the evaluation cache's CRC
and ``checkpoint_committed`` after each save.  They run between chunks,
so a guarded run that no fault hits is the bare run bit for bit, and
``resilience=None`` adds no operation and no host sync.

**A mesh** (``mesh``, a ``DeviceMesh`` with an ``"actor"`` dim, in the
actor-learner and async topologies; ``rl.distributed``): every rank calls
``train`` with the same arguments; each runs ``num_actors / size`` actors
on its own generators (``distributed.rank_generator`` of the env and loop
streams; the params' and the evaluator's are the same on every rank), the
learner's updates averaged over the ranks, and every rank returns the
same rewards, divergences and learner params (a calibrated evaluation
packs on every rank's observations, gathered).  Not ported yet, and
raising ``NotImplementedError`` naming ROADMAP queue A item 14c: a mesh
with checkpoints or with the resilience hooks (the supervisor).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch import checkpoint as ckpt_lib
from repro_torch.core import fake_quant
from repro_torch.core import metrics as metrics_lib
from repro_torch.core.qconfig import QuantConfig, QuantMode
from repro_torch.device import resolve_device
from repro_torch.rl import a2c, actor_learner, actorq, common, ddpg, \
    distributed, dqn, ppo
from repro_torch.rl import buffer as rb
from repro_torch.rl.env import Env, evaluate
from repro_torch.rl.envs import make as make_env
from repro_torch.rl.networks import make_network

ALGOS = ("dqn", "a2c", "ppo", "ddpg")
MODULES = {"dqn": dqn, "a2c": a2c, "ppo": ppo, "ddpg": ddpg}


def _not_ported(what: str, item: str) -> NotImplementedError:
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
                     checkpoint_dir, resume, resilience):
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
    if mesh is not None and (checkpoint_dir or resume):
        raise _not_ported("a checkpoint of a mesh run (sharded replay)",
                          "14c")
    if mesh is not None and resilience is not None:
        raise _not_ported("the resilience hooks and the supervisor under a "
                          "mesh", "14c")


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


def _loop_checkpointer(checkpoint_dir, checkpoint_every: int,
                       resume: bool, keep: int):
    """The train loop's ``AsyncCheckpointer``, or None without a directory
    (``checkpoint_every`` or ``resume`` without one raise ``ValueError``:
    the run would silently save nothing)."""
    if not checkpoint_dir:
        if resume:
            raise ValueError("resume=True needs checkpoint_dir")
        if checkpoint_every:
            raise ValueError("checkpoint_every > 0 needs checkpoint_dir")
        return None
    return ckpt_lib.AsyncCheckpointer(checkpoint_dir, keep=keep)


def _generator_states(*generators: torch.Generator) -> tuple:
    """Each generator's state (a CPU uint8 tensor): checkpoint leaves."""
    return tuple(g.get_state() for g in generators)


def _set_generator_states(generators, states) -> None:
    for g, st in zip(generators, states):
        g.set_state(st)


def _save_due(i: int, last_saved: int, every: int, iterations: int) -> bool:
    """A save lands at the first chunk or round end ``every`` iterations
    after the last one, and at the run's end."""
    return every > 0 and (i - last_saved >= every
                          or (i == iterations and i > last_saved))


def _evaluator(env: Env, cfg, act_fn, g_eval: torch.Generator,
               eval_episodes: int, device, eval_steps: List[int],
               ax: distributed.Axis):
    """``evaluate_at(params, observers, step, obs, guard=None) -> float``:
    the eval reward of the learner's params -- through the packed actor
    when the backend is quantized (calibrated on the live ``obs`` with
    ``calib_batch``: every rank's, gathered on ``ax``), else the greedy
    fp32 policy under the QAT context.
    ``guard(cache, remint)`` returns the cache to evaluate (the
    resilience hook ``on_eval_cache``; ``remint()`` packs it again).  Each
    batched eval step adds one to ``eval_steps[0]``."""
    quantized = actorq.is_quantized(cfg.actor_backend)

    def counted(act):
        def step(p, o):
            eval_steps[0] += 1
            return act(p, o)
        return step
    q_act = counted(actorq.make_act_fn(env.spec)) if quantized else None
    det_act = counted(lambda p, o: act_fn(p[0], o, p[1], p[2]))

    def evaluate_at(params, observers, step, obs, guard=None) -> float:
        if q_act is not None:
            obs_g = obs.reshape((-1,) + tuple(env.spec.obs_shape))
            if cfg.calib_batch:
                obs_g = ax.gather(obs_g)

            def mint():
                return actorq.make_actor_cache(
                    params, cfg.actor_backend,
                    calib_obs=actorq.calib_slice(obs_g, cfg.calib_batch)
                    if cfg.calib_batch else None)
            qparams = mint()
            if guard is not None:
                qparams = guard(qparams, mint)
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
          resume: bool = False, checkpoint_keep: int = 3,
          resilience: Any = None, device=None) -> TrainResult:
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
    bitwise the actor-learner run with ``sync_every=1``.

    ``checkpoint_dir`` with ``checkpoint_every > 0`` saves the run every
    that many iterations (and at its end), keeping the newest
    ``checkpoint_keep`` steps (``<= 0``: all); ``resume=True`` continues
    from the newest valid step there, bitwise the run that was not
    stopped, or starts afresh when there is none.  ``resilience`` (a
    ``repro_torch.resilience.ResilienceContext``; the supervisor passes
    one) runs its hooks around every chunk or round (module docstring).
    ``mesh`` (actor-learner and async; module docstring) runs this rank's
    share of the actors; every rank calls ``train`` alike.
    ``device=None`` is ``cuda``.
    """
    _check_supported(algo, topology, num_actors, sync_every, mesh,
                     async_barrier, quant, replay, priority_exponent,
                     checkpoint_dir, resume, resilience)
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

    ax = distributed.Axis(mesh, "actor")

    def gen(offset):
        return torch.Generator(device=device).manual_seed(seed + offset)

    def rank_gen(offset):
        return distributed.rank_generator(gen(offset), ax.index)
    g_params = torch.Generator().manual_seed(seed)
    ckpt = dict(checkpoint_dir=checkpoint_dir,
                checkpoint_every=checkpoint_every, resume=resume,
                checkpoint_keep=checkpoint_keep)
    if topology == "async":
        return _train_async(algo, env, net, cfg, g_params, gen, rank_gen,
                            ax, iterations=iterations,
                            record_every=record_every,
                            eval_episodes=eval_episodes,
                            steps_per_call=steps_per_call,
                            num_actors=num_actors, sync_every=sync_every,
                            barrier=async_barrier, device=device,
                            resilience=resilience, **ckpt)
    if topology == "actor-learner":
        al = actor_learner.ActorLearnerConfig(num_actors=num_actors,
                                              sync_every=sync_every)
        state = actor_learner.init(g_params, env, net, algo, cfg, al,
                                   mesh=mesh)
        iteration, act_fn, benv = actor_learner.make_actor_learner(
            algo, env, net, cfg, al, mesh=mesh, device=device)
    else:
        state = mod.init(g_params, env, net, cfg)
        if quant.is_qat:
            state = state._replace(observers=_bootstrap_observers(
                algo, env, net, state, quant))
        iteration, act_fn, benv = mod.make_iteration(env, net, cfg, device)
    env_state, obs = benv.reset(rank_gen(1), device)
    g_run, g_eval = rank_gen(2), gen(3)
    eval_steps = [0]
    evaluate_at = _evaluator(env, cfg, act_fn, g_eval, eval_episodes,
                             device, eval_steps, ax)
    chunks: Dict[int, Callable] = {}
    rewards, variances, divergences = [], [], []
    i = 0
    ckptr = _loop_checkpointer(checkpoint_dir, checkpoint_every, resume,
                               checkpoint_keep)
    try:
        if ckptr is not None and resume and (
                start := ckptr.latest_step()) is not None:
            # the template is the fresh run of the same config: every
            # leaf is held against it before anything is read
            tree, extra = ckptr.restore(start, dict(
                state=state, env_state=env_state, obs=obs,
                generators=_generator_states(g_run, g_eval)))
            state, env_state, obs = (tree["state"], tree["env_state"],
                                     tree["obs"])
            _set_generator_states((g_run, g_eval), tree["generators"])
            i, eval_steps[0] = extra["iteration"], extra["eval_steps"]
            rewards, variances = extra["rewards"], extra["action_variances"]
            divergences = extra["divergences"]
        last_saved = i
        t0 = time.time()
        while i < iterations:
            if resilience is not None:
                resilience.round_start(i)
                resilience.dropped_sync_na(i, topology)
            next_stop = min((i // record_every + 1) * record_every,
                            iterations)
            n = min(max(steps_per_call, 1), next_stop - i)
            if n not in chunks:
                chunks[n] = make_scan_iteration(iteration, n)
            state, env_state, obs, metrics = chunks[n](state, env_state,
                                                       obs, g_run)
            i += n
            if resilience is not None:
                state = _guard_round(resilience, state, i, cfg)
            if i % record_every == 0 or i == iterations:
                learner = state.learner if isinstance(
                    state, actor_learner.ActorLearnerState) else state
                rewards.append(evaluate_at(
                    learner.params, learner.observers, learner.step, obs,
                    guard=_eval_guard(resilience, i)))
                variances.append(next(
                    (float(metrics[k][-1]) for k in (
                        "action_dist_variance", "mean_q_var")
                     if k in metrics), 0.0))
                # the first push is at iteration sync_every: a record
                # point before it would only see the init-time zeros
                if "divergence" in metrics and i >= sync_every:
                    divergences.append(metrics["divergence"][-1].tolist())
            if ckptr is not None and _save_due(i, last_saved,
                                               checkpoint_every, iterations):
                # after this point's evaluation, so the saved generators
                # have made its draws and the resumed run makes the next
                ckptr.save_async(
                    i, dict(state=state, env_state=env_state, obs=obs,
                            generators=_generator_states(g_run, g_eval)),
                    extra=dict(iteration=i, eval_steps=eval_steps[0],
                               rewards=rewards, action_variances=variances,
                               divergences=divergences))
                last_saved = i
                if resilience is not None:
                    resilience.checkpoint_committed(ckptr, i)
        wall = time.time() - t0
        if ckptr is not None:
            ckptr.wait()
    finally:
        if ckptr is not None:
            ckptr.close()
    if isinstance(state, actor_learner.ActorLearnerState):
        state = state.learner
    return TrainResult(state=state, act_fn=act_fn, env=env, rewards=rewards,
                       action_variances=variances, wall_time_s=wall,
                       algo_cfg=cfg, net=net, device=device,
                       eval_steps=eval_steps[0], divergences=divergences)


def _eval_guard(resilience, step: int):
    """The ``guard`` of ``evaluate_at`` at round ``step``: the
    resilience hook ``on_eval_cache``, or None."""
    if resilience is None:
        return None
    return lambda cache, remint: resilience.on_eval_cache(cache, step,
                                                          remint)


def _guard_round(resilience, state, step: int, cfg):
    """``after_round`` of the fused and actor-learner drivers.

    The fused ``TrainState`` holds the learner's params; an
    ``ActorLearnerState`` holds them in ``learner`` and carries the
    actors' packed cache, the bitflip_push target, which, when minting is
    deterministic (``calib_batch == 0``), is held by CRC to a fresh pack
    of the actors' params (``actor_learner.remint_cache``) at the guard's
    cadence.
    """
    if not isinstance(state, actor_learner.ActorLearnerState):
        return resilience.after_round(
            state, step, learner_view=lambda s: s.params,
            set_learner=lambda s, p: s._replace(params=p))
    state = resilience.after_round(
        state, step, learner_view=lambda s: s.learner.params,
        set_learner=lambda s, p: s._replace(
            learner=s.learner._replace(params=p)),
        repack=lambda s, fn: s if isinstance(s.actor_cache, tuple)
        else actor_learner.with_cache(s, fn(s.actor_cache)))
    if (actorq.is_quantized(cfg.actor_backend) and cfg.calib_batch == 0
            and not isinstance(state.actor_cache, tuple)
            and step % max(resilience.guard.check_every, 1) == 0):
        resilience.verify_state_cache(
            state.actor_cache,
            lambda: actor_learner.remint_cache(state, cfg.actor_backend),
            step)
    return state


def _train_async(algo: str, env: Env, net, cfg, g_params: torch.Generator,
                 gen, rank_gen, ax: distributed.Axis, *,
                 iterations: int, record_every: int, eval_episodes: int,
                 steps_per_call: int, num_actors: int, sync_every: int,
                 barrier: bool, device, checkpoint_dir=None,
                 checkpoint_every: int = 0, resume: bool = False,
                 checkpoint_keep: int = 3, resilience=None) -> TrainResult:
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
    each chunk wait for the other's last one.  A checkpoint first joins
    both streams to the current one, whose host copy then waits for the
    round; it holds the learner, the write slot (``None`` with the
    barrier: the one slot rides in the learner), the env state, the
    observations and the actors' snapshot.

    With ``resilience``, the learner's guard (and a nan_grad) runs on the
    learner's stream, whose work it waits for; the push is
    ``resilience.push`` around ``make_snapshot``, each mint followed by the
    current stream waiting for the learner's, so the CRC's host copies
    read the finished snapshot; a ``None`` push (dropped) leaves the
    actors on their snapshot and the lag widens.
    """
    al = actor_learner.ActorLearnerConfig(num_actors=num_actors,
                                          sync_every=sync_every)
    progs = actor_learner.make_async_actor_learner(algo, env, net, cfg, al,
                                                   mesh=ax.mesh,
                                                   device=device)
    learner, wbuf = actor_learner.init_async(g_params, env, net, algo, cfg,
                                             al, double=not barrier,
                                             mesh=ax.mesh)
    env_state, obs = progs.benv_global.reset(rank_gen(1), device)
    g_run, g_eval = rank_gen(2), gen(3)
    eval_steps = [0]
    evaluate_at = _evaluator(env, cfg, progs.act_fn, g_eval, eval_episodes,
                             device, eval_steps, ax)
    streams = progs.streams
    streams.start()
    streams.share((learner, wbuf, env_state, obs))
    snap = progs.make_snapshot(learner, obs)
    rewards, variances, actor_lags, divs = [], [], [], []
    updates_since_push = total_updates = snap_minted_at = 0
    i = 0

    def run_tree():
        # the barrier's one slot rides in the learner: saving wbuf too
        # would hold the buffer twice
        return dict(learner=learner, wbuf=None if barrier else wbuf,
                    env_state=env_state, obs=obs, snap=snap,
                    generators=_generator_states(g_run, g_eval))
    ckptr = _loop_checkpointer(checkpoint_dir, checkpoint_every, resume,
                               checkpoint_keep)
    try:
        if ckptr is not None and resume and (
                start := ckptr.latest_step()) is not None:
            tree, extra = ckptr.restore(start, run_tree())
            learner, env_state, obs, snap = (
                tree["learner"], tree["env_state"], tree["obs"],
                tree["snap"])
            wbuf = None if barrier else tree["wbuf"]
            _set_generator_states((g_run, g_eval), tree["generators"])
            # the restored tensors were written on the current stream
            streams.start()
            streams.share((learner, wbuf, env_state, obs, snap))
            i, eval_steps[0] = extra["iteration"], extra["eval_steps"]
            rewards, variances = extra["rewards"], extra["action_variances"]
            actor_lags, divs = extra["actor_lags"], extra["divergences"]
            updates_since_push = extra["updates_since_push"]
            total_updates = extra["total_updates"]
            snap_minted_at = extra["snap_minted_at"]
        last_saved = i
        t0 = time.time()
        while i < iterations:
            if resilience is not None:
                resilience.round_start(i)
            next_stop = min((i // record_every + 1) * record_every,
                            iterations)
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
            if resilience is not None:
                with streams.on_learner():
                    guarded = resilience.after_round(
                        learner, i, learner_view=lambda s: s.params,
                        set_learner=lambda s, p: s._replace(params=p))
                if guarded is not learner:
                    streams.share(guarded)
                learner = guarded
            if updates_since_push >= sync_every and (
                    resilience is None or resilience.sync_due(i)):
                if not barrier:
                    learner, wbuf = actor_learner.swap_read_slot(
                        learner, wbuf, streams)
                if resilience is None:
                    new_snap = progs.make_snapshot(learner, obs)
                else:
                    new_snap = _guarded_push(resilience, progs, learner,
                                             obs, i)
                if new_snap is not None:
                    actor_lags.append(total_updates - snap_minted_at)
                    snap = new_snap
                    snap_minted_at = total_updates
                    divs.append(progs.divergence(learner, snap, obs))
                    updates_since_push = 0
            if i % record_every == 0 or i == iterations:
                streams.learner_waits_for_actors()
                streams.share(obs)
                with streams.on_learner():
                    rewards.append(evaluate_at(
                        learner.params, learner.observers, learner.step,
                        obs, guard=_eval_guard(resilience, i)))
                # neither chunk surfaces an action variance (the
                # reference records the same zeros)
                variances.append(0.0)
            if ckptr is not None and _save_due(i, last_saved,
                                               checkpoint_every, iterations):
                # the host copies wait for the current stream, which
                # waits for both; a round is never clipped for a save
                streams.finish()
                divs = [d if isinstance(d, list) else d.tolist()
                        for d in divs]
                ckptr.save_async(i, run_tree(), extra=dict(
                    iteration=i, eval_steps=eval_steps[0], rewards=rewards,
                    action_variances=variances, divergences=divs,
                    actor_lags=actor_lags,
                    updates_since_push=updates_since_push,
                    total_updates=total_updates,
                    snap_minted_at=snap_minted_at))
                last_saved = i
                if resilience is not None:
                    resilience.checkpoint_committed(ckptr, i)
        streams.finish()
        wall = time.time() - t0
        if ckptr is not None:
            ckptr.wait()
    finally:
        if ckptr is not None:
            ckptr.close()
    return TrainResult(state=learner, act_fn=progs.act_fn, env=env,
                       rewards=rewards, action_variances=variances,
                       wall_time_s=wall, algo_cfg=cfg, net=net,
                       device=device, eval_steps=eval_steps[0],
                       divergences=[d if isinstance(d, list) else d.tolist()
                                    for d in divs],
                       actor_lags=actor_lags)


def _guarded_push(resilience, progs, learner, obs, step: int):
    """``resilience.push`` of the async snapshot: each mint is made on the
    learner's stream (``make_snapshot``) and the current stream then waits
    for it, so the CRC's host copies read it whole.  The snapshot pushed
    (or None) is then shared with both streams, which wait for the
    current one: a corrupted copy the guard let through was rebuilt
    there."""
    streams = progs.streams

    def mint():
        snap = progs.make_snapshot(learner, obs)
        streams.current_waits_for_learner()
        return snap
    snap = resilience.push(mint, step)
    if snap is not None:
        streams.start()
        streams.share(snap)
    return snap


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
