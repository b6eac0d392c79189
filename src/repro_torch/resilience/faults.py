"""Deterministic, seeded fault injection for the ActorQ runtime.

Counterpart of ``repro/resilience/faults.py``.  A chaos run is a
``FaultPlan``: a seed and a list of ``FaultSpec`` entries, each naming a
fault kind, the driver round it fires at and the kind's knobs.  Plans
parse from a compact string (``launch/train.py --fault-plan``)::

    "7:nan_grad@3,bitflip_push@5:nbits=3,actor_crash@8:shard=1"

Fault kinds (``FAULT_KINDS``):

* ``actor_crash``  -- an actor shard dies: ``ActorCrashError`` at the
  start of the target round; the supervisor resumes from the last
  checkpoint and records the shard as quarantined.
* ``straggler``    -- a slow actor: sleeps ``delay_s`` at the start of
  the round (the watchdog sees the stalled heartbeat).
* ``bitflip_push`` -- flips ``nbits`` bits of the packed int8/int4
  payload of the next push (async: the minted snapshot; actor-learner:
  the carried in-state cache; fused: the record point's eval cache); the
  integrity guard's CRC catches it.
* ``nan_grad``     -- writes NaN (or Inf, ``mode=inf``) into the learner
  params after the target round, as a non-finite gradient would; the
  finite guard catches it at its next check.
* ``dropped_sync`` -- the next due push never happens (async: the host's
  push is skipped and the actor lag widens).  The fused and actor-learner
  topologies push inside their iteration, so there it is recorded as not
  applicable instead of fired.
* ``crash_commit`` -- a crash after a checkpoint's commit: the step's
  data file (``leaves.bin``) is truncated, a torn write that the
  manifest's crc32 must refuse on load.

Every fault is injected by the host between chunks, so the device work
of the rounds that survive is untouched: that is what makes recovery
bitwise.  ``FaultInjector`` owns which entries have fired and is shared
across the supervisor's attempts, so a fault does not fire again after
the restart it caused.  ``ResilienceContext`` bundles the injector and
the guards into the one object ``loops.train(resilience=...)`` takes.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import DATA_FILE
from repro_torch.core.ptq import tree_flatten, tree_unflatten
from repro_torch.resilience import guards

FAULT_KINDS = ("actor_crash", "straggler", "bitflip_push", "nan_grad",
               "dropped_sync", "crash_commit")


class FaultError(RuntimeError):
    """Base class for errors raised by injected faults."""


class ActorCrashError(FaultError):
    """An actor shard crashed (injected or real)."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One planned fault: kind, target driver round, kind knobs.

    ``step`` is the 0-based driver round the fault arms at; ``repeat`` how
    many times it fires before it is spent.  ``shard`` targets
    ``actor_crash``; ``delay_s`` is the ``straggler``'s sleep; ``nbits``
    the number of ``bitflip_push`` flips; ``mode`` NaN or Inf for
    ``nan_grad``.
    """

    kind: str
    step: int
    shard: int = 0
    delay_s: float = 0.05
    nbits: int = 1
    mode: str = "nan"
    repeat: int = 1

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; expected "
                             f"one of {FAULT_KINDS}")
        if self.mode not in ("nan", "inf"):
            raise ValueError(f"nan_grad mode must be nan|inf, "
                             f"got {self.mode!r}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seed plus the ordered fault entries of one chaos run."""

    seed: int
    faults: Tuple[FaultSpec, ...] = ()

    @staticmethod
    def parse(spec: str) -> "FaultPlan":
        """Parse ``SEED:kind@step[:key=val...][,entry...]``: integer knobs
        as int, ``delay_s`` as float, ``mode`` as str."""
        head, _, rest = spec.partition(":")
        try:
            seed = int(head)
        except ValueError:
            raise ValueError(
                f"fault plan must start with 'SEED:', got {spec!r}")
        faults: List[FaultSpec] = []
        for entry in filter(None, rest.split(",")):
            parts = entry.split(":")
            kind, _, step_s = parts[0].partition("@")
            if not step_s:
                raise ValueError(f"fault entry {entry!r} needs 'kind@step'")
            kw: Dict[str, Any] = {}
            for p in parts[1:]:
                k, _, v = p.partition("=")
                if k == "delay_s":
                    kw[k] = float(v)
                elif k == "mode":
                    kw[k] = v
                else:
                    kw[k] = int(v)
            faults.append(FaultSpec(kind=kind, step=int(step_s), **kw))
        return FaultPlan(seed=seed, faults=tuple(faults))

    def spec_string(self) -> str:
        """Inverse of ``parse`` (reports round-trip their plans)."""
        entries = []
        for f in self.faults:
            s = f"{f.kind}@{f.step}"
            defaults = FaultSpec(kind=f.kind, step=f.step)
            for field in ("shard", "delay_s", "nbits", "mode", "repeat"):
                v = getattr(f, field)
                if v != getattr(defaults, field):
                    s += f":{field}={v}"
            entries.append(s)
        return f"{self.seed}:{','.join(entries)}"


def _host_copy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return np.array(leaf.detach().cpu().numpy())
    return np.array(leaf)


def bitflip_tree(tree: Any, seed: int, nbits: int = 1) -> Any:
    """Flip ``nbits`` random bits across a tree's leaf payloads.

    The (leaf, byte, bit) triples come from ``np.random.default_rng(seed)``
    over the leaves in ``core.ptq.tree_flatten``'s order, the reference's
    flatten order, so the same plan flips the same bits as the reference
    on a cache packed from the same params.  Each leaf is copied to the
    host, flipped there and rebuilt on its own device with its dtype and
    shape; the input is not changed.
    """
    _, leaves = tree_flatten(tree)
    host = [_host_copy(x) for x in leaves]
    sizes = np.array([h.nbytes for h in host], dtype=np.int64)
    total = int(sizes.sum())
    if total == 0:
        return tree
    rng = np.random.default_rng(seed)
    offsets = np.cumsum(sizes)
    for flat_bit in rng.integers(0, total * 8, size=max(nbits, 1)):
        byte, bit = divmod(int(flat_bit), 8)
        li = int(np.searchsorted(offsets, byte, side="right"))
        local = byte - (0 if li == 0 else int(offsets[li - 1]))
        buf = host[li].reshape(-1).view(np.uint8)
        buf[local] ^= np.uint8(1 << bit)
    rebuilt = [torch.from_numpy(h).to(x.device)
               if isinstance(x, torch.Tensor) else h.item()
               for x, h in zip(leaves, host)]
    return tree_unflatten(tree, rebuilt)


def poison_params(params: Any, mode: str = "nan") -> Any:
    """The tree with its first float leaf's first element NaN/Inf.

    Out of place: the poisoned leaf is a copy (on its device), the other
    leaves are the input's, so a host copy or snapshot still reading the
    old tensors sees them unchanged.  One poisoned value is enough: it
    spreads through every later update.
    """
    bad = float("nan") if mode == "nan" else float("inf")
    _, leaves = tree_flatten(params)
    out = list(leaves)
    for i, x in enumerate(leaves):
        if isinstance(x, torch.Tensor) and x.is_floating_point() \
                and x.numel():
            y = x.detach().clone(memory_format=torch.contiguous_format)
            y.view(-1)[0] = bad
            out[i] = y
            break
    return tree_unflatten(params, out)


def truncate_file(path, keep_bytes: int = 7) -> None:
    """Truncate a file to ``keep_bytes``: a torn write, after the commit."""
    with open(path, "r+b") as f:
        f.truncate(keep_bytes)
        f.flush()
        os.fsync(f.fileno())


class FaultInjector:
    """Stateful consumer of a ``FaultPlan``.

    Owns each entry's remaining fires, and is shared across the
    supervisor's attempts: a fault that fired (and crashed the run) does
    not fire again when the resume replays its round.  ``fired`` records
    every injection as ``(kind, step, detail)``; ``not_applicable`` the
    faults the topology cannot take (``dropped_sync`` where the push is in
    the iteration).
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._remaining = [f.repeat for f in plan.faults]
        self.fired: List[Tuple[str, int, str]] = []
        self.not_applicable: List[Tuple[str, int, str]] = []

    def pending(self, kind: str, step: int) -> Optional[int]:
        """Index of an armed entry of ``kind`` due at ``step``: the first
        opportunity with ``step >= f.step`` (chunked drivers advance
        rounds by ``steps_per_call``, so equality would skip targets
        inside a chunk)."""
        for i, f in enumerate(self.plan.faults):
            if f.kind == kind and step >= f.step and self._remaining[i] > 0:
                return i
        return None

    def take(self, kind: str, step: int) -> Optional[FaultSpec]:
        """Consume one fire of an armed entry; None when none is due."""
        i = self.pending(kind, step)
        if i is None:
            return None
        self._remaining[i] -= 1
        return self.plan.faults[i]

    def record_fired(self, kind: str, step: int, detail: str = "") -> None:
        """Log an injection that happened."""
        self.fired.append((kind, step, detail))

    def record_na(self, kind: str, step: int, why: str) -> None:
        """Log a planned fault this topology cannot take."""
        self.not_applicable.append((kind, step, why))

    @property
    def injected_count(self) -> int:
        """Number of faults that fired."""
        return len(self.fired)


class ResilienceContext:
    """The hook object ``loops.train(resilience=...)`` takes.

    Bundles a ``FaultInjector`` (None for guards-only runs) with a
    ``GuardConfig`` and gives the drivers their hooks:

    * ``round_start(step)`` -- fires actor_crash / straggler;
    * ``after_round(state, step, learner_view=, set_learner=, repack=)``
      -- fires nan_grad and (with ``repack``) bitflip_push on a carried
      in-state cache, then the finite guard at the ``check_every``
      cadence; returns the (possibly corrupted) state, so the guard, not
      the injector, stops the run;
    * ``verify_state_cache(cache, reference_mint, step)`` -- the carried
      cache against a fresh mint, by CRC;
    * ``on_eval_cache(cache, step, remint)`` -- an evaluation's cache:
      bitflip_push target, verified, re-minted on failure;
    * ``sync_due(step)`` / ``push(mint, step)`` -- the async push:
      dropped_sync, then mint, corrupt?, verify, re-mint (bounded);
    * ``dropped_sync_na(step, topology)`` -- where a push cannot drop;
    * ``checkpoint_committed(ckptr, step)`` / ``after_checkpoint`` --
      crash_commit tears the step just saved;
    * ``serving_fault_hook()`` -- the per-batch hook of a
      ``PolicyServer``;
    * ``heartbeat(phase, step)`` -- the supervisor's watchdog.

    Every hook runs on the host between chunks and does nothing when no
    fault is due and no guard is on.
    """

    def __init__(self, injector: Optional[FaultInjector] = None,
                 guard: Optional[guards.GuardConfig] = None,
                 on_heartbeat: Optional[Callable[[str, int], None]] = None,
                 sleep: Callable[[float], None] = time.sleep):
        self.injector = injector
        self.guard = guards.GuardConfig() if guard is None else guard
        self._on_heartbeat = on_heartbeat
        self._sleep = sleep
        self.quarantined: List[int] = []
        self.events: List[Tuple[str, int, str]] = []

    # -- bookkeeping ----------------------------------------------------
    def _log(self, what: str, step: int, detail: str = "") -> None:
        self.events.append((what, step, detail))

    def heartbeat(self, phase: str, step: int) -> None:
        """Report liveness to the supervisor's watchdog (if attached)."""
        if self._on_heartbeat is not None:
            self._on_heartbeat(phase, step)

    @property
    def seed(self) -> int:
        """The plan's seed (0 for guards-only contexts): keys the jitter
        and the bit flips."""
        return self.injector.plan.seed if self.injector else 0

    def _take(self, kind: str, step: int) -> Optional[FaultSpec]:
        if self.injector is None:
            return None
        return self.injector.take(kind, step)

    # -- driver hooks ---------------------------------------------------
    def round_start(self, step: int) -> None:
        """Start of a round: actor_crash and straggler fire here."""
        self.heartbeat("round", step)
        f = self._take("straggler", step)
        if f is not None:
            self.injector.record_fired("straggler", step,
                                       f"delay_s={f.delay_s}")
            self._log("straggler", step, f"slept {f.delay_s}s")
            self._sleep(f.delay_s)
        f = self._take("actor_crash", step)
        if f is not None:
            self.injector.record_fired("actor_crash", step,
                                       f"shard={f.shard}")
            if f.shard not in self.quarantined:
                self.quarantined.append(f.shard)
            raise ActorCrashError(f"actor shard {f.shard} crashed at round "
                                  f"{step} (injected)")

    def after_round(self, state, step: int, *, learner_view=None,
                    set_learner=None, repack=None):
        """After a round's updates: nan_grad / bitflip_push, then the
        finite guard.

        ``learner_view(state)`` gives the learner params and
        ``set_learner(state, params)`` writes them back (both identity by
        default); ``repack(state, corrupt_fn)`` rebuilds the state around
        a corrupted copy of its carried cache (topologies that carry one).
        """
        f = self._take("nan_grad", step)
        if f is not None:
            self.injector.record_fired("nan_grad", step, f.mode)
            self._log("nan_grad", step, f"poisoned ({f.mode})")
            view = state if learner_view is None else learner_view(state)
            poisoned = poison_params(view, f.mode)
            state = poisoned if set_learner is None \
                else set_learner(state, poisoned)
        if repack is not None:
            # the entry is consumed only where an in-state cache is the
            # target; otherwise the push or eval-cache hook owns it
            f = self._take("bitflip_push", step)
            if f is not None:
                self.injector.record_fired(
                    "bitflip_push", step, f"nbits={f.nbits} (in-state cache)")
                self._log("bitflip_push", step, "corrupted in-state cache")
                state = repack(state, lambda c: bitflip_tree(
                    c, self.seed + step, f.nbits))
        if (self.guard.check_finite
                and step % max(self.guard.check_every, 1) == 0):
            view = state if learner_view is None else learner_view(state)
            guards.check_finite(view, what=f"learner params @round {step}")
        return state

    def verify_state_cache(self, cache, reference_mint, step: int) -> None:
        """Hold a carried in-state cache to a fresh mint by CRC (and its
        structure).  Sound only where minting is deterministic
        (``calib_batch == 0``); callers gate on that."""
        if not self.guard.verify_pushes:
            return
        ref = reference_mint()
        guards.verify_crc(cache, guards.tree_crc32(ref),
                          what=f"in-state actor cache @round {step}")
        if self.guard.validate_codes:
            guards.validate_cache(cache,
                                  what=f"in-state actor cache @round {step}")

    def on_eval_cache(self, cache, step: int, remint):
        """Guard (and maybe corrupt) a freshly minted eval cache.

        ``remint()`` rebuilds it from the fp32 params: the repair and the
        verification reference.  Returns the cache to use.
        """
        f = self._take("bitflip_push", step)
        if f is not None:
            self.injector.record_fired("bitflip_push", step,
                                       f"nbits={f.nbits} (eval cache)")
            self._log("bitflip_push", step, "corrupted eval cache")
            cache = bitflip_tree(cache, self.seed + step, f.nbits)
        if not self.guard.verify_pushes:
            return cache

        attempt = [0]

        def check_or_remint():
            if attempt[0] > 0:
                c = remint()
                self._log("push_retry", step,
                          f"re-minted eval cache (attempt {attempt[0]})")
            else:
                c = cache
            attempt[0] += 1
            guards.verify_crc(c, guards.tree_crc32(remint()),
                              what=f"eval cache @round {step}")
            if self.guard.validate_codes:
                guards.validate_cache(c, what=f"eval cache @round {step}")
            return c

        return guards.retry_call(
            check_or_remint, retries=self.guard.push_retries,
            base_s=self.guard.backoff_base_s,
            factor=self.guard.backoff_factor,
            cap_s=self.guard.backoff_cap_s, seed=self.seed + step,
            retry_on=guards.GuardError, sleep=self._sleep)

    def sync_due(self, step: int) -> bool:
        """Consume a due dropped_sync; False skips this push entirely (the
        async driver asks before swapping slots, so the actor lag widens
        until the next cadence point)."""
        f = self._take("dropped_sync", step)
        if f is not None:
            self.injector.record_fired("dropped_sync", step)
            self._log("dropped_sync", step, "push skipped")
            return False
        return True

    def push(self, mint, step: int):
        """Guarded async push: mint, corrupt?, verify, retry.

        ``mint()`` makes the snapshot.  A due dropped_sync consumes the
        push and returns None.  A due bitflip_push corrupts the payload
        once; the CRC against a second mint catches it and the push is
        minted again (bounded, deterministic backoff), so a transient
        corruption costs one retry and a persistent one escalates its
        typed error.
        """
        self.heartbeat("push", step)
        if self._take("dropped_sync", step) is not None:
            self.injector.record_fired("dropped_sync", step)
            self._log("dropped_sync", step, "push skipped")
            return None
        corrupt_once = [self._take("bitflip_push", step)]

        def mint_verify():
            snap = mint()
            fs = corrupt_once[0]
            if fs is not None:
                corrupt_once[0] = None
                self.injector.record_fired("bitflip_push", step,
                                           f"nbits={fs.nbits} (push)")
                self._log("bitflip_push", step, "corrupted push payload")
                snap = bitflip_tree(snap, self.seed + step, fs.nbits)
            if self.guard.verify_pushes:
                ref_crc = guards.tree_crc32(mint())
                guards.verify_crc(snap, ref_crc,
                                  what=f"param push @update {step}")
                if self.guard.validate_codes:
                    guards.validate_cache(snap,
                                          what=f"param push @update {step}")
            return snap

        def on_retry(attempt, exc):
            self._log("push_retry", step, f"{type(exc).__name__}: {exc}")

        return guards.retry_call(
            mint_verify, retries=self.guard.push_retries,
            base_s=self.guard.backoff_base_s,
            factor=self.guard.backoff_factor,
            cap_s=self.guard.backoff_cap_s, seed=self.seed + step,
            retry_on=guards.GuardError, on_retry=on_retry,
            sleep=self._sleep)

    def dropped_sync_na(self, step: int, topology: str) -> None:
        """Record a dropped_sync that cannot fire (the push is in the
        iteration)."""
        f = self._take("dropped_sync", step)
        if f is not None:
            self.injector.record_na(
                "dropped_sync", step,
                f"sync is compiled into the {topology} step; cannot be "
                f"dropped from the host")

    def checkpoint_committed(self, ckptr, step: int) -> None:
        """After ``ckptr.save_async(step, ...)``: cheap unless a
        crash_commit is armed; then drain the writer, so the commit is on
        disk, and tear it (``after_checkpoint``): the crash lands after
        the rename, where the manifest's crc32 must catch it."""
        self.heartbeat("checkpoint", step)
        if (self.injector is None
                or self.injector.pending("crash_commit", step) is None):
            return
        ckptr.wait()
        self.after_checkpoint(ckptr.manager.step_path(step), step)

    def after_checkpoint(self, ckpt_path, step: int) -> None:
        """crash_commit truncates the step's data file (``leaves.bin``)."""
        self.heartbeat("checkpoint", step)
        if ckpt_path is None:
            return
        f = self._take("crash_commit", step)
        if f is None:
            return
        leaves = os.path.join(ckpt_path, DATA_FILE)
        if os.path.exists(leaves):
            truncate_file(leaves)
            self.injector.record_fired("crash_commit", step, str(ckpt_path))
            self._log("crash_commit", step, f"truncated {leaves}")

    def serving_fault_hook(self):
        """The per-batch hook of ``PolicyServer(fault_hook=...)``: an armed
        ``actor_crash`` raises (the server's worker restarts), a
        ``straggler`` sleeps.  Steps count dispatched batches."""
        count = [0]

        def hook(batch):
            step = count[0]
            count[0] += 1
            f = self._take("straggler", step)
            if f is not None:
                self.injector.record_fired("straggler", step,
                                           f"serving delay {f.delay_s}s")
                self._sleep(f.delay_s)
            f = self._take("actor_crash", step)
            if f is not None:
                self.injector.record_fired("actor_crash", step,
                                           "serving worker")
                raise ActorCrashError(
                    f"serving worker crashed at batch {step} (injected)")

        return hook
