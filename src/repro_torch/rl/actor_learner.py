"""ActorQ's actor-learner topologies: quantized actors fill a replay
buffer, an fp32 learner trains on it and pushes its params back.

Counterpart of ``repro/rl/actor_learner.py`` for its two replay
algorithms, ``"dqn"`` and ``"ddpg"`` (the paper's D4PG-style split: the
actors run DDPG's mu head, the critic stays with the learner), on one
device, the reference's no-mesh mode: the ``num_actors`` actors are one
batched env of ``num_actors * n_envs`` rows (actor-major), stepped by one
behaviour policy, so an int8/int4 actor runs one B1 launch a layer (or one
B2 launch, calibrated) over all actors' rows, with one dynamic activation
scale, as the reference's folded batch does.

* ``topology="actor-learner"`` (``make_actor_learner``) -- bulk
  synchronous: an iteration is the rollout, the write into the sharded
  replay (a shard per actor), ``updates_per_iter`` learner updates on
  per-shard samples, and, every ``sync_every`` iterations, the push: the
  actors take the learner's params and the packed cache is made again
  (only then: between pushes it is bitwise unchanged).
* ``topology="async"`` (``make_async_actor_learner``) -- actor chunks and
  learner chunks run on two CUDA streams over a double-buffered replay:
  the actors fill the write slot while the learner drains the read slot.
  At a sync point the host exchanges the slots and mints a snapshot
  (params, packed cache, schedule counters) for the actors.
  ``sync_every`` counts learner updates there.

**Divergence** is recorded at true pushes only: per actor, the mean
absolute gap between the actors' behaviour head (the packed cache, or the
pushed fp32 params) and the learner's fp32 head on that actor's current
observations (DQN's Q-values, DDPG's ``tanh`` actions).  The reference
``vmap``s the quantized head over actors, so
each actor's activations get their own dynamic scale: the port runs one
head call per actor (one B1 launch per actor and layer, or one B2 launch
per actor), never one over all actors' rows.

**Random draws.**  One device generator serves the whole run, drawn in
host order: the rollout's exploration and env resets, then the learner's
samples.  Per-shard sampling is one draw of shape ``(num_actors,
per_actor_batch)`` in both topologies; with one actor it is the fused
driver's draw.  So ``num_actors=1, sync_every=1`` is bitwise the fused
driver, and async with ``async_barrier=True, steps_per_call=1,
sync_every=updates_per_iter`` is bitwise the actor-learner topology.  A
CUDA generator reserves its Philox offset on the host when a draw is
launched, so one generator shared by two streams gives the same numbers
whatever order the streams run in.

**Streams** (``Streams``; no-ops on the CPU).  The actors' work runs on
one stream and the learner's on another; nothing between two sync points
waits on the host.  At a sync point the learner waits for the actors'
last write (the slot it now reads, the observations the snapshot and the
divergence read), and the actors wait for the snapshot's mint, which runs
on the learner's stream after every learner update so far.  A tensor made
on one stream and read on the other is marked with ``record_stream``
(``Streams.share``), so the caching allocator does not hand its memory
out while the other stream may still read it.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core.ptq import tree_map, tree_tensors
from repro_torch.device import resolve_device
from repro_torch.rl import actorq, common, ddpg, dqn
from repro_torch.rl import buffer as rb
from repro_torch.rl.env import Env, batched_env, rollout

ALGOS = ("dqn", "ddpg")
_MODULES = {"dqn": dqn, "ddpg": ddpg}
TOPOLOGIES = ("fused", "actor-learner", "async")


def validate_topology(topology: str) -> str:
    """Return ``topology`` if it is one of ``TOPOLOGIES``, else raise
    ``ValueError``."""
    if topology not in TOPOLOGIES:
        raise ValueError(f"topology must be one of {TOPOLOGIES}, "
                         f"got {topology!r}")
    return topology


@dataclasses.dataclass(frozen=True)
class ActorLearnerConfig:
    """The topology's knobs.  ``sync_every`` is the staleness contract:
    iterations between pushes in the synchronous topology (each
    ``updates_per_iter`` learner updates), learner updates under async."""

    num_actors: int = 2
    sync_every: int = 1


class ActorLearnerState(NamedTuple):
    """The synchronous topology's carry: the fp32 learner (its replay
    sharded), the actors' possibly stale params, their packed cache
    (``()`` for fp32 actors), the iterations done ``t`` (a host int) and
    the last push's divergence ``(num_actors,)``."""

    learner: common.TrainState
    actor_params: Any
    actor_cache: Any
    t: int
    divergence: torch.Tensor


class ActorSnapshot(NamedTuple):
    """What the async actors know of the learner: the params (and their
    packed cache) of the last push, and the step and learner updates at
    its mint.  Every tensor is the snapshot's own copy."""

    params: Any
    cache: Any
    step: torch.Tensor
    updates: torch.Tensor


class Streams:
    """The actors' and the learner's CUDA streams and the joins between
    them.  On the CPU there is one order of work, the host's, and every
    method is a no-op."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.actor = torch.cuda.Stream(device)
            self.learner = torch.cuda.Stream(device)

    def on_actor(self):
        """Context: work enqueued inside runs on the actors' stream."""
        return (torch.cuda.stream(self.actor) if self.cuda
                else contextlib.nullcontext())

    def on_learner(self):
        """Context: work enqueued inside runs on the learner's stream."""
        return (torch.cuda.stream(self.learner) if self.cuda
                else contextlib.nullcontext())

    @staticmethod
    def _wait(waiter, producer) -> None:
        event = torch.cuda.Event()
        event.record(producer)
        waiter.wait_event(event)

    def learner_waits_for_actors(self) -> None:
        """Later learner work starts after the actors' work so far."""
        if self.cuda:
            self._wait(self.learner, self.actor)

    def actors_wait_for_learner(self) -> None:
        """Later actor work starts after the learner's work so far."""
        if self.cuda:
            self._wait(self.actor, self.learner)

    def current_waits_for_learner(self) -> None:
        """The current stream's later work (a host copy) starts after the
        learner's work so far."""
        if self.cuda:
            self._wait(torch.cuda.current_stream(self.learner.device),
                       self.learner)

    def start(self) -> None:
        """Both streams wait for the current stream (the set-up)."""
        if self.cuda:
            current = torch.cuda.current_stream(self.actor.device)
            self._wait(self.actor, current)
            self._wait(self.learner, current)

    def finish(self) -> None:
        """The current stream waits for both."""
        if self.cuda:
            current = torch.cuda.current_stream(self.actor.device)
            self._wait(current, self.actor)
            self._wait(current, self.learner)

    def share(self, tree: Any) -> None:
        """Mark every tensor of ``tree`` as used by both streams
        (``record_stream``): its memory is not reused until the work
        either stream has queued by the time it is freed is done."""
        if not self.cuda:
            return
        for _, t in tree_tensors(tree):
            t.record_stream(self.actor)
            t.record_stream(self.learner)


class AsyncPrograms(NamedTuple):
    """The async topology's program set (``make_async_actor_learner``).

    ``actor_chunk(snap, env_state, obs, wbuf, generator, *, n_chunks) ->
    (env_state, obs, wbuf, {"reward"})`` and ``learner_chunk(learner,
    generator, *, n_updates) -> (learner, {"loss"})`` are the two hot
    paths, each on its own stream; ``make_snapshot(learner, obs)`` (the
    push) and ``divergence(learner, snap, obs) -> (num_actors,)`` run at
    sync points on the learner's stream.  ``act_fn`` is the greedy fp32
    policy; ``benv_global`` the ``num_actors * n_envs`` envs.
    """

    actor_chunk: Callable
    learner_chunk: Callable
    make_snapshot: Callable
    divergence: Callable
    act_fn: Callable
    benv_global: Env
    streams: Streams


class _AlgoParts(NamedTuple):
    build_policy: Callable        # (params, observers, step, updates,
    #                                cache) -> policy
    learn: Callable               # the algorithm's learner update
    fp32_head: Callable           # (params, obs, observers, step) -> head
    cache_head: Callable          # (packed cache, obs) -> behaviour head
    act_fn: Callable              # deterministic eval policy


def _check_algo(algo: str) -> None:
    if algo not in ALGOS:
        raise ValueError(f"actor-learner supports {ALGOS}, got {algo!r}")


def _algo_parts(algo: str, env: Env, net, cfg) -> _AlgoParts:
    """Behaviour, learner and head builders shared by both topologies:
    DQN's Q head and greedy actions, or DDPG's ``tanh`` mu head (the
    packed cache's through ``tanh(quantized_apply)``) and its actions
    scaled by ``action_scale``."""
    _check_algo(algo)
    if algo == "dqn":
        build = dqn.make_behaviour_policy(env, net, cfg)

        def build_policy(params, observers, step, updates, cache):
            return build(params, observers, step, updates, qparams=cache)

        def fp32_head(params, obs, observers, step):
            return dqn._q_values(net, cfg, params, obs, observers, step)[0]

        def act_fn(params, obs, observers=None, step=1 << 30):
            step = torch.as_tensor(step, device=obs.device)
            q = fp32_head(params, obs, observers or {}, step)
            return torch.argmax(q, dim=-1).to(torch.int32)

        return _AlgoParts(build_policy, dqn.make_td_update(env, net, cfg),
                          fp32_head, actorq.quantized_apply, act_fn)
    build = ddpg.make_behaviour_policy(env, net, cfg)

    def build_policy(params, observers, step, updates, cache):
        return build(params, observers, step, qparams=cache)

    def fp32_head(params, obs, observers, step):
        return ddpg._actor_out(net, cfg, params, obs, observers, step)[0]

    def cache_head(cache, obs):
        return torch.tanh(actorq.quantized_apply(cache, obs))

    def act_fn(params, obs, observers=None, step=1 << 30):
        step = torch.as_tensor(step, device=obs.device)
        return fp32_head(params, obs, observers or {}, step) \
            * env.spec.action_scale

    return _AlgoParts(build_policy, ddpg.make_update(env, net, cfg),
                      fp32_head, cache_head, act_fn)


def _validate(algo: str, cfg, al: ActorLearnerConfig, mesh) -> int:
    _check_algo(algo)
    if mesh is not None:
        raise NotImplementedError(
            "a device mesh over the actor axis is not ported yet (ROADMAP "
            "queue A, item 14); one device runs the actors as a batch")
    actorq.validate_actor_backend(cfg.actor_backend)
    if al.sync_every < 1:
        raise ValueError(f"sync_every must be >= 1, got {al.sync_every}")
    n = al.num_actors
    if n < 1:
        raise ValueError(f"num_actors must be >= 1, got {n}")
    if cfg.batch_size % n:
        raise ValueError(f"batch_size {cfg.batch_size} must divide by "
                         f"num_actors {n}")
    return n


def _make_to_shards(n_actors: int, envs_per_actor: int):
    """``(T, n_actors * envs_per_actor, ...)`` rollout leaves -> per-shard
    ``(n_actors, T * envs_per_actor, ...)`` batches (actor-major)."""
    def to_shards(x):
        t_dim, trail = x.shape[0], tuple(x.shape[2:])
        y = x.reshape((t_dim, n_actors, envs_per_actor) + trail)
        return y.movedim(1, 0).reshape(
            (n_actors, t_dim * envs_per_actor) + trail)
    return to_shards


def _shard_batch(traj, to_shards) -> rb.Transition:
    return rb.Transition(*(to_shards(x) for x in (
        traj.obs, traj.action, traj.reward, traj.done, traj.next_obs)))


def _make_learner_phase(parts: _AlgoParts, cfg, use_per: bool,
                        per_actor_batch: int):
    """``learner_phase(learner, generator, total_size, n_updates) ->
    (learner, losses)``: per-shard sample, fp32 update (and, prioritized,
    the per-shard priority push), ``n_updates`` times; shared by the
    synchronous iteration and the async learner chunk."""
    learn = parts.learn

    def flat(shards):
        return rb.Transition(*(x.reshape((-1,) + tuple(x.shape[2:]))
                               for x in shards))

    def learner_phase(learner, generator, total_size, n_updates):
        losses = []
        for _ in range(n_updates):
            replay = learner.extras.replay
            if use_per:
                beta = common.per_beta(learner, cfg)
                shards, idx, w = rb.per_sample_sharded(
                    replay, generator, per_actor_batch, beta)
                learner, (loss, td_abs) = learn(
                    learner, flat(shards), total_size, weights=w.reshape(-1))
                per = rb.per_update_priorities_sharded(
                    learner.extras.replay, idx, td_abs.reshape(idx.shape),
                    cfg.priority_exponent)
                learner = learner._replace(
                    extras=learner.extras._replace(replay=per))
            else:
                shards = rb.replay_sample_sharded(replay, generator,
                                                  per_actor_batch)
                learner, (loss, _) = learn(learner, flat(shards),
                                           total_size)
            losses.append(loss)
        return learner, torch.stack(losses)
    return learner_phase


def _make_divergence(parts: _AlgoParts, quantized: bool, n_actors: int,
                     envs_per_actor: int, obs_shape):
    """``divergence(learner, actor_params, cache, obs) -> (n_actors,)``:
    per actor, ``mean |behaviour head - fp32 learner head|`` on that
    actor's observations, one head call per actor (so a quantized head
    takes each actor's own activation scale, as the reference's vmap)."""
    def divergence(learner, actor_params, cache, obs):
        obs_a = obs.reshape((n_actors, envs_per_actor) + tuple(obs_shape))
        gaps = []
        for o in obs_a:
            fresh = parts.fp32_head(learner.params, o, learner.observers,
                                    learner.step)
            if quantized:
                behaved = parts.cache_head(cache, o)
            else:
                behaved = parts.fp32_head(actor_params, o,
                                          learner.observers, learner.step)
            gaps.append(torch.mean(torch.abs(behaved - fresh)))
        return torch.stack(gaps)
    return divergence


def _sharded_init(algo: str, env: Env, cfg):
    """``make_slot(n_shards, capacity, device)`` of the run's replay
    discipline (DDPG's slots hold float ``(action_dim,)`` actions)."""
    init_sharded = rb.per_init_sharded \
        if rb.use_prioritized(cfg.replay, cfg.priority_exponent) \
        else rb.replay_init_sharded
    action = dict(action_shape=(env.spec.action_dim,),
                  action_dtype=torch.float32) if algo == "ddpg" else {}

    def make_slot(n_shards: int, capacity: int, device):
        return init_sharded(n_shards, capacity, env.spec.obs_shape,
                            device=device, **action)
    return make_slot


def _make_cache(params, cfg, obs):
    """The actors' packed cache of ``params``, calibrated on ``obs`` when
    ``cfg.calib_batch > 0``."""
    calib = actorq.calib_slice(obs, cfg.calib_batch) if cfg.calib_batch \
        else None
    return actorq.make_actor_cache(params, cfg.actor_backend,
                                   calib_obs=calib)


def init(generator: torch.Generator, env: Env, net, algo: str, cfg,
         al: ActorLearnerConfig) -> ActorLearnerState:
    """Learner state, the actors' copy (and its packed cache) and the
    sharded replay (``buffer_size / num_actors`` a shard).

    ``generator`` is the CPU generator of the algorithm's ``init``
    (``dqn.init`` or ``ddpg.init``) params; with
    ``calib_batch > 0`` the first cache calibrates on a fresh reset of
    ``calib_batch`` envs drawn from it next (no rollout exists yet).
    """
    _check_algo(algo)
    n = al.num_actors
    if n < 1 or cfg.buffer_size % n:
        raise ValueError(f"buffer_size {cfg.buffer_size} must divide by "
                         f"num_actors {n}")
    state = _MODULES[algo].init(generator, env, net, cfg)
    dev = state.step.device
    sharded = _sharded_init(algo, env, cfg)(n, cfg.buffer_size // n, dev)
    state = state._replace(extras=state.extras._replace(replay=sharded))
    actor_params = tree_map(torch.clone, state.params)
    cache = ()
    if actorq.is_quantized(cfg.actor_backend):
        obs = None
        if cfg.calib_batch:
            _, obs = batched_env(env, cfg.calib_batch).reset(generator, dev)
        cache = _make_cache(actor_params, cfg, obs)
    return ActorLearnerState(learner=state, actor_params=actor_params,
                             actor_cache=cache, t=0,
                             divergence=torch.zeros(n, device=dev))


def init_async(generator: torch.Generator, env: Env, net, algo: str, cfg,
               al: ActorLearnerConfig, *, double: bool = True):
    """``(learner_state, write_slot)`` of the async topology: the learner
    carries the read slot in ``extras.replay``, each slot ``buffer_size /
    (2 * num_actors)`` a shard.  ``double=False`` (the ``async_barrier``
    mode) keeps one slot of the synchronous topology's capacity, and
    ``write_slot`` is ``None``."""
    _check_algo(algo)
    n = al.num_actors
    slots = 2 if double else 1
    if n < 1 or cfg.buffer_size % (n * slots):
        raise ValueError(
            f"buffer_size {cfg.buffer_size} must divide by num_actors x "
            f"slots = {n} x {slots} (double-buffered async replay)")
    state = _MODULES[algo].init(generator, env, net, cfg)
    dev = state.step.device
    make_slot = _sharded_init(algo, env, cfg)
    cap = cfg.buffer_size // (n * slots)
    if double:
        db = rb.double_buffer_init(make_slot, n, cap, dev)
        read, write = db.read, db.write
    else:
        read, write = make_slot(n, cap, dev), None
    return state._replace(extras=state.extras._replace(replay=read)), write


def swap_read_slot(learner: common.TrainState, wbuf,
                   streams: Streams = None):
    """The async sync point's slot exchange: the freshly written slot
    becomes the learner's read slot, the drained one the actors' write
    slot (``buffer.double_buffer_swap``, a host exchange of references).
    With ``streams``, both slots are marked as used by both streams."""
    db = rb.double_buffer_swap(
        rb.DoubleBuffer(read=learner.extras.replay, write=wbuf))
    if streams is not None:
        streams.share(db)
    return (learner._replace(extras=learner.extras._replace(replay=db.read)),
            db.write)


def with_cache(state: ActorLearnerState, cache) -> ActorLearnerState:
    """``state`` with its packed actor cache replaced."""
    return state._replace(actor_cache=cache)


def remint_cache(state: ActorLearnerState, actor_backend: str):
    """A fresh pack of the stale actor params, ``()`` for fp32 actors:
    with ``calib_batch == 0`` it is bitwise the carried cache."""
    if not actorq.is_quantized(actor_backend) or isinstance(
            state.actor_cache, tuple):
        return ()
    return actorq.make_actor_cache(state.actor_params, actor_backend)


class _Setup(NamedTuple):
    n: int
    benv: Env                      # num_actors * n_envs envs
    quantized: bool
    parts: _AlgoParts
    learner_phase: Callable
    to_shards: Callable
    add: Callable                  # the discipline's sharded write
    divergence: Callable


def _setup(algo: str, env: Env, net, cfg, al: ActorLearnerConfig, mesh,
           device) -> _Setup:
    """What both topologies build from the config."""
    n = _validate(algo, cfg, al, mesh)
    use_per = rb.use_prioritized(cfg.replay, cfg.priority_exponent)
    envs = n * cfg.n_envs
    benv = actorq.maybe_attach_seq_state(batched_env(env, envs), net,
                                         cfg.actor_backend, envs, device)
    quantized = actorq.is_quantized(cfg.actor_backend)
    parts = _algo_parts(algo, env, net, cfg)
    return _Setup(
        n, benv, quantized, parts,
        _make_learner_phase(parts, cfg, use_per, cfg.batch_size // n),
        _make_to_shards(n, cfg.n_envs),
        rb.per_add_sharded if use_per else rb.replay_add_sharded,
        _make_divergence(parts, quantized, n, cfg.n_envs,
                         env.spec.obs_shape))


def make_actor_learner(algo: str, env: Env, net, cfg,
                       al: ActorLearnerConfig, mesh=None, device=None):
    """``(iteration, act_fn, benv_global)`` of the synchronous topology.

    ``iteration(state, env_state, obs, generator) -> (state, env_state,
    obs, metrics)``, the fused iteration's contract, so the fused driver
    and its chunks drive it as they are; ``metrics`` (loss, reward per
    finished episode, the last push's divergence) stay on the device.
    ``benv_global`` batches ``num_actors * n_envs`` envs.  ``device=None``
    is ``cuda``; ``mesh`` raises (ROADMAP queue A, item 14).
    """
    su = _setup(algo, env, net, cfg, al, mesh, resolve_device(device))
    parts, quantized = su.parts, su.quantized

    def iteration(state: ActorLearnerState, env_state, obs,
                  generator: torch.Generator):
        """Rollout of the stale actors, replay write, learner updates,
        and the push when the cadence says so."""
        learner, actor_params = state.learner, state.actor_params
        policy = parts.build_policy(actor_params, learner.observers,
                                    learner.step, learner.extras.updates,
                                    state.actor_cache if quantized else None)
        env_state, obs, traj = rollout(su.benv, policy, actor_params,
                                       env_state, obs, generator,
                                       cfg.rollout_steps)
        replay = su.add(learner.extras.replay,
                        _shard_batch(traj, su.to_shards))
        learner = learner._replace(
            extras=learner.extras._replace(replay=replay))
        learner, losses = su.learner_phase(learner, generator,
                                           rb.replay_total_size(replay),
                                           cfg.updates_per_iter)
        # the first push is at t == sync_every: at t = 0 the actors hold a
        # fresh copy by construction, which is no push
        t = state.t + 1
        cache, div = state.actor_cache, state.divergence
        if t % al.sync_every == 0:
            actor_params = learner.params
            if quantized:
                cache = _make_cache(actor_params, cfg, obs)
            div = su.divergence(learner, actor_params, cache, obs)
        metrics = {"loss": torch.mean(losses),
                   "reward": torch.sum(traj.reward) / torch.clamp(
                       torch.sum(traj.done), min=1.0),
                   "divergence": div}
        return (ActorLearnerState(learner, actor_params, cache, t, div),
                env_state, obs, metrics)

    return iteration, parts.act_fn, su.benv


def make_async_actor_learner(algo: str, env: Env, net, cfg,
                             al: ActorLearnerConfig, mesh=None,
                             device=None) -> AsyncPrograms:
    """The async topology's program set (see ``AsyncPrograms``).

    The actor chunk runs ``n_chunks`` rollouts of ``rollout_steps`` with
    the snapshot's params (and packed cache), each written into the write
    slot; the learner chunk runs ``n_updates`` learner updates on the
    read slot.  Neither waits on the host or on the other: the driver
    joins them at sync points (``make_snapshot``) and, in its barrier
    mode, around every chunk.  ``mesh`` raises (ROADMAP queue A, item
    14); ``device=None`` is ``cuda``.
    """
    device = resolve_device(device)
    su = _setup(algo, env, net, cfg, al, mesh, device)
    parts, quantized = su.parts, su.quantized
    streams = Streams(device)

    def make_snapshot(learner: common.TrainState, obs) -> ActorSnapshot:
        """The push: on the learner's stream, after the actors' work so
        far (``obs`` is theirs), copy the params and pack (and, with
        ``calib_batch``, calibrate on ``obs``) the cache; the actors'
        later work waits for it."""
        streams.learner_waits_for_actors()
        streams.share(obs)
        with streams.on_learner():
            params = tree_map(torch.clone, learner.params)
            snap = ActorSnapshot(
                params=params,
                cache=_make_cache(params, cfg, obs) if quantized else (),
                step=learner.step.clone(),
                updates=learner.extras.updates.clone())
        streams.share(snap)
        streams.actors_wait_for_learner()
        return snap

    def actor_chunk(snap: ActorSnapshot, env_state, obs, wbuf,
                    generator: torch.Generator, *, n_chunks: int):
        """``n_chunks`` rollouts into the write slot, on the actors'
        stream."""
        with streams.on_actor():
            policy = parts.build_policy(snap.params, {}, snap.step,
                                        snap.updates,
                                        snap.cache if quantized else None)
            rewards = []
            for _ in range(n_chunks):
                env_state, obs, traj = rollout(
                    su.benv, policy, snap.params, env_state, obs, generator,
                    cfg.rollout_steps)
                wbuf = su.add(wbuf, _shard_batch(traj, su.to_shards))
                rewards.append(torch.sum(traj.reward) / torch.clamp(
                    torch.sum(traj.done), min=1.0))
            reward = torch.mean(torch.stack(rewards))
        return env_state, obs, wbuf, {"reward": reward}

    def learner_chunk(learner: common.TrainState,
                      generator: torch.Generator, *, n_updates: int):
        """``n_updates`` learner updates on the read slot, on the
        learner's stream."""
        with streams.on_learner():
            learner, losses = su.learner_phase(
                learner, generator,
                rb.replay_total_size(learner.extras.replay), n_updates)
            loss = torch.mean(losses)
        return learner, {"loss": loss}

    def divergence(learner: common.TrainState, snap: ActorSnapshot, obs):
        """``(num_actors,)`` gap of a fresh snapshot's behaviour head to
        the learner's, on the learner's stream (after ``make_snapshot``,
        which waited for ``obs``)."""
        with streams.on_learner():
            return su.divergence(learner, snap.params, snap.cache, obs)

    return AsyncPrograms(actor_chunk=actor_chunk,
                         learner_chunk=learner_chunk,
                         make_snapshot=make_snapshot, divergence=divergence,
                         act_fn=parts.act_fn, benv_global=su.benv,
                         streams=streams)
