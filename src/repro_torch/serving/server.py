"""Policy server: packed-actor cache registry, hot-swap, dispatch loop.

Counterpart of ``repro/serving/server.py``.  ``PolicyServer`` multiplexes
any number of open sessions onto shape-bucketed padded batches answered by
ONE immutable actor-cache snapshot per dispatch:

* **Cache registry / hot-swap.**  ``push_params`` packs the learner's fp32
  params into the backend's serving form (``rl.actorq`` int8/int4
  packing, calibrated when ``calib_batch > 0`` so MLP actors run the fused
  single-launch kernel; fp32 keeps the params as they are) and publishes
  it as a frozen ``CacheEntry`` under a single reference assignment.  A
  dispatch reads that reference once, so a swap never tears a batch
  across two versions.
* **Dispatch loop.**  One worker thread drains the ``Batcher`` admission
  queue and calls ``serve_batch``; each bucket is one fixed launch shape.
* **Device.**  The cache and every launch live on ``device``: ``None``
  means ``cuda`` (the kernels' path), and a server without CUDA raises.
  ``device="cpu"`` runs the plain versions (the tests).
"""
from __future__ import annotations

import dataclasses
import threading
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import ptq
from repro_torch.device import resolve_device
from repro_torch.resilience import guards as _guards
from repro_torch.rl import actorq, networks
from repro_torch.rl.env import batched_env
from repro_torch.serving.batcher import (Batcher, Request, pad_rows,
                                         remove_padding, select_bucket)
from repro_torch.serving.session import SessionTable, StepCounter

DEFAULT_BUCKETS = (8, 32, 128, 512)


def make_fp32_act_fn(env_spec) -> Callable:
    """Deterministic fp32 policy ``act(params, obs)`` with the quantized
    ``actorq.make_act_fn`` head contract (MLP params; TF32 off)."""
    networks.full_fp32()
    if env_spec.continuous:
        def act(params, obs):
            """Continuous head: tanh * action_scale, f32 actions."""
            return torch.tanh(networks.mlp_apply(params, obs)) \
                * env_spec.action_scale
    else:
        n_act = env_spec.n_actions

        def act(params, obs):
            """Discrete head: argmax over n_actions outputs, int32."""
            out = networks.mlp_apply(params, obs)
            return torch.argmax(out[..., :n_act], dim=-1).to(torch.int32)
    return act


@dataclasses.dataclass(frozen=True, eq=False)
class CacheEntry:
    """One immutable published actor cache.

    ``cache`` is the serving tree (packed ``QuantizedParams`` for int8 /
    int4, calibrated when the server has ``calib_batch > 0``, or the fp32
    params), ``version`` the monotone push counter, ``nbytes`` its
    parameter-memory footprint, ``pushed_at`` a ``perf_counter`` stamp,
    ``crc32`` the push-time checksum ``verify_current`` re-checks.
    """

    cache: Any
    version: int
    actor_backend: str
    nbytes: int
    pushed_at: float
    crc32: int = 0


def _cache_device(qparams) -> torch.device:
    return next(t for _, t in ptq.tree_tensors(qparams)).device


@torch.no_grad()
def greedy_calib_obs(env, qparams, calib_batch: int, seed: int = 0
                     ) -> torch.Tensor:
    """Collect ``calib_batch`` observations for deploy-time calibration.

    Rolls the served greedy policy (over the freshly packed ``qparams``)
    a few steps from reset on the cache's device -- reset draws alone
    would under-span the ranges the policy then visits.  Returns
    ``(calib_batch, *obs_shape)`` f32.
    """
    roll_steps = 8
    device = _cache_device(qparams)
    benv = batched_env(env, max(-(-calib_batch // roll_steps), 1))
    act = actorq.make_act_fn(env.spec)
    state, obs = benv.reset(torch.Generator().manual_seed(seed), device)
    seen = [obs]
    for _ in range(roll_steps - 1):
        state, obs, _, _ = benv.step(state, act(qparams, obs))
        seen.append(obs)
    return torch.cat(seen)[:calib_batch]


class PolicyServer:
    """Continuous-batching policy server over one actor cache.

    Args:
        env_spec: ``rl.env.EnvSpec`` -- obs shape and action head.
        actor_backend: ``"fp32" | "int8" | "int4"`` serving cache format.
        buckets: ascending padded batch shapes; the largest is the
            admission ``max_batch``.
        max_wait_us: admission straggler wait (``batcher.Batcher``).
        calib_batch: > 0 calibrates static activation params at every
            push from the observations handed to ``push_params`` (MLP
            caches then serve through the fused kernel); 0 keeps the
            dynamic per-layer path.
        device: where the cache lives and the kernels run; ``None`` is
            ``cuda``.
    """

    def __init__(self, env_spec, *, actor_backend: str = "int8",
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 max_wait_us: int = 2000, calib_batch: int = 0,
                 device=None):
        """See class docstring."""
        actorq.validate_actor_backend(actor_backend)
        if not buckets or list(buckets) != sorted(set(int(b) for b in
                                                      buckets)):
            raise ValueError(f"buckets must be ascending and unique, "
                             f"got {buckets!r}")
        self.device = resolve_device(device)
        self.env_spec = env_spec
        self.actor_backend = actor_backend
        self.buckets = tuple(int(b) for b in buckets)
        self.max_wait_us = int(max_wait_us)
        self.calib_batch = int(calib_batch)
        if actorq.is_quantized(actor_backend):
            self._step_fn = actorq.make_act_fn(env_spec)
        else:
            self._step_fn = make_fp32_act_fn(env_spec)
        self._entry: Optional[CacheEntry] = None
        self._calib_obs = None              # last calibration batch seen
        self._push_mu = threading.Lock()
        self._versions = StepCounter()
        self.batcher = self._make_batcher()
        self.sessions = SessionTable()
        self.steps = StepCounter()          # dispatch (batch) tickets
        self._served = 0                    # requests answered
        self._padded = 0                    # padding rows dispatched
        self._bucket_counts: Dict[int, int] = {b: 0 for b in self.buckets}
        self._worker: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._dispatch_failures = 0
        self._consecutive_failures = 0
        self._last_error: Optional[str] = None
        self._wedged = 0

    def _make_batcher(self) -> Batcher:
        return Batcher(max_batch=self.buckets[-1],
                       max_wait_us=self.max_wait_us)

    # -- cache registry / hot-swap -----------------------------------------

    @torch.no_grad()
    def push_params(self, params, calib_obs=None) -> CacheEntry:
        """Pack + publish a new actor cache; returns the new entry.

        ``params`` is the fp32 param tree (any device; it is copied to the
        server's).  Quantized backends pack it via
        ``actorq.make_actor_cache``; with ``calib_batch > 0`` the cache is
        calibrated on ``calib_obs`` (numpy or tensor), or on the most
        recent calibration batch if omitted.  The swap is one reference
        assignment.
        """
        params = ptq.tree_to(params, self.device)
        if actorq.is_quantized(self.actor_backend):
            calib = None
            if self.calib_batch > 0:
                if calib_obs is not None:
                    calib = actorq.calib_slice(
                        torch.as_tensor(calib_obs, dtype=torch.float32,
                                        device=self.device),
                        self.calib_batch)
                    self._calib_obs = calib
                else:
                    calib = self._calib_obs
            cache = actorq.make_actor_cache(params, self.actor_backend,
                                            calib_obs=calib)
            # a structurally corrupt pack raises HERE; the live entry keeps
            # serving
            _guards.validate_cache(cache, what="pushed serving cache")
        else:
            cache = params
        crc = _guards.tree_crc32(cache)
        with self._push_mu:
            entry = CacheEntry(cache=cache, version=self._versions.next(),
                               actor_backend=self.actor_backend,
                               nbytes=ptq.tree_nbytes(cache),
                               pushed_at=time.perf_counter(), crc32=crc)
            self._entry = entry              # the atomic hot-swap
        return entry

    def verify_current(self) -> CacheEntry:
        """Re-checksum the live cache against its push-time CRC
        (``IntegrityError`` on any bit difference)."""
        entry = self._entry
        if entry is None:
            raise RuntimeError("no actor cache: call push_params first")
        _guards.verify_crc(entry.cache, entry.crc32,
                           what=f"serving cache v{entry.version}")
        return entry

    @property
    def current(self) -> Optional[CacheEntry]:
        """The live cache entry (``None`` before the first push)."""
        return self._entry

    # -- session lifecycle -------------------------------------------------

    def open_session(self) -> int:
        """Open a serving session; returns its id."""
        return self.sessions.open(at_step=self.steps.value)

    def close_session(self, sid: int) -> None:
        """Close session ``sid`` (its queued requests still complete)."""
        self.sessions.close(sid)

    # -- request path ------------------------------------------------------

    def submit(self, sid: int, obs) -> Request:
        """Enqueue one observation (no batch axis) for session ``sid``;
        returns the ``Request`` whose ``result()`` blocks for the action.

        Raises ``KeyError`` for unknown/closed sessions and ``ValueError``
        on a shape mismatch.
        """
        self.sessions.checkout(sid)
        obs = np.asarray(obs, dtype=np.float32)
        if obs.shape != tuple(self.env_spec.obs_shape):
            raise ValueError(f"obs shape {obs.shape} != spec "
                             f"{tuple(self.env_spec.obs_shape)}")
        req = Request(sid, obs)
        self.batcher.put(req)
        return req

    def _act(self, cache, obs: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(obs).to(self.device)
        with torch.no_grad():
            return self._step_fn(cache, x).cpu().numpy()

    def serve_batch(self, requests: List[Request]) -> None:
        """Answer one admitted batch against a single cache snapshot.

        Stacks the observations, pads to the selected bucket (repeat last
        row), runs the act function once, unpads, and completes every
        request with its action + the snapshot's version.
        """
        entry = self._entry   # single snapshot read -- hot-swap safety
        if entry is None:
            raise RuntimeError("no actor cache: call push_params first")
        try:
            n = len(requests)
            bucket = select_bucket(n, self.buckets)
            obs = pad_rows(np.stack([r.obs for r in requests]), bucket)
            actions = remove_padding(self._act(entry.cache, obs), n)
            step = self.steps.next()
            t_done = time.perf_counter()
            self._served += n
            self._padded += bucket - n
            self._bucket_counts[bucket] += 1
            for r, a in zip(requests, actions):
                self.sessions.on_step(r.sid, entry.version)
                r.complete(a, entry.version, step, t_done)
        except Exception as e:              # fail waiters, don't hang them
            for r in requests:
                r.fail(e)
            raise

    def serve(self, sid_obs: Sequence) -> List[np.ndarray]:
        """Synchronous: serve ``[(sid, obs), ...]`` as admitted batches and
        return the actions in order (no worker thread)."""
        reqs = [self.submit(sid, obs) for sid, obs in sid_obs]
        batch = self.batcher.get_batch(timeout=0)
        served: List[Request] = []
        while batch:
            self.serve_batch(batch)
            served.extend(batch)
            batch = self.batcher.get_batch(timeout=0)
        if len(served) != len(reqs):
            err = RuntimeError(
                f"dispatch drained {len(served)} of {len(reqs)} admitted "
                f"requests -- batcher admission invariant violated")
            drained = {id(r) for r in served}
            for r in reqs:
                if id(r) not in drained:
                    r.fail(err)
            raise err
        return [r.result(timeout=0).action for r in reqs]

    # -- dispatch loop -----------------------------------------------------

    def _run(self) -> None:
        """Worker body: drain the admission queue until stopped.

        A failed dispatch has already failed its own requests, so the loop
        keeps serving, counting each failure and backing off (capped at
        100 ms) on consecutive ones.
        """
        consecutive = 0
        while not self._stop.is_set():
            batch = self.batcher.get_batch(timeout=0.05)
            if not batch:
                continue
            try:
                self.serve_batch(batch)
                consecutive = 0
                self._consecutive_failures = 0
            except Exception as e:
                self._dispatch_failures += 1
                consecutive += 1
                self._consecutive_failures = consecutive
                self._last_error = f"{type(e).__name__}: {e}"
                self._stop.wait(
                    min(0.001 * (2 ** min(consecutive, 7)), 0.1))

    def start(self) -> "PolicyServer":
        """Start the background dispatch thread (idempotent; a stopped
        server restarts with a fresh admission queue)."""
        if self._worker is None or not self._worker.is_alive():
            if self.batcher.closed:
                self.batcher = self._make_batcher()
            self._stop.clear()
            self._worker = threading.Thread(target=self._run,
                                            name="policy-server",
                                            daemon=True)
            self._worker.start()
        return self

    def stop(self, join_timeout: float = 5.0) -> None:
        """Stop dispatching; queued-but-unserved requests fail fast.  A
        worker that does not join within ``join_timeout`` is reported as
        wedged (``stats()`` and a ``RuntimeWarning``)."""
        self._stop.set()
        drained = self.batcher.close()
        err = RuntimeError("server stopped")
        for r in drained:
            r.fail(err)
        if self._worker is not None:
            self._worker.join(timeout=join_timeout)
            if self._worker.is_alive():
                self._wedged += 1
                warnings.warn(
                    f"policy-server worker failed to stop within "
                    f"{join_timeout}s (wedged in dispatch) -- thread "
                    f"leaked, see stats()['worker']", RuntimeWarning,
                    stacklevel=2)
            else:
                self._worker = None

    def __enter__(self) -> "PolicyServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- ops ---------------------------------------------------------------

    def warmup(self) -> None:
        """Run the act function once at every bucket shape, so first
        requests do not pay the kernels' build and first-launch cost."""
        entry = self._entry
        if entry is None:
            raise RuntimeError("no actor cache: call push_params first")
        for b in self.buckets:
            self._act(entry.cache, np.zeros(
                (b,) + tuple(self.env_spec.obs_shape), np.float32))

    def stats(self) -> Dict[str, Any]:
        """Serving counters snapshot: ``served``, ``dispatches``,
        ``padding_rows``, ``bucket_counts``, ``version``, ``cache_nbytes``,
        ``last_error``, the ``worker`` health sub-dict and the ``sessions``
        counters."""
        entry = self._entry
        return {
            "served": self._served,
            "dispatches": self.steps.value,
            "padding_rows": self._padded,
            "bucket_counts": dict(self._bucket_counts),
            "version": -1 if entry is None else entry.version,
            "cache_nbytes": 0 if entry is None else entry.nbytes,
            "last_error": self._last_error,
            "worker": {
                "dispatch_failures": self._dispatch_failures,
                "consecutive_failures": self._consecutive_failures,
                "wedged": self._wedged,
                "alive": (self._worker is not None
                          and self._worker.is_alive()),
            },
            "sessions": self.sessions.stats(),
        }
