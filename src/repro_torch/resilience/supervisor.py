"""Supervised training driver: watchdog, retry, rollback, abort.

Counterpart of ``repro/resilience/supervisor.py``.  ``supervise(...)``
wraps ``loops.train`` in the escalation a long ActorQ run needs:

1. **Retry** -- a typed fault, guard or checkpoint error restarts the run
   from the newest *valid* checkpoint (``resume=True``; a torn step is
   skipped by ``CheckpointManager.latest_step``), up to ``max_retries``
   times with deterministic-jitter backoff between attempts.  Resume is
   bitwise, so a retried run is the run that never faulted.
2. **Rollback** -- when retries run out (the newest checkpoint itself
   reproduces the failure: it holds poisoned params), that step is
   deleted and the retry budget resets, up to ``max_rollbacks`` times.
3. **Abort** -- when rollbacks run out too, ``SupervisorAbort`` carries a
   ``SupervisorReport`` (attempts, faults fired and not applicable,
   quarantined shards, watchdog stalls).

The **watchdog** reads the heartbeats the hooks send (round, push,
checkpoint) on a monitor thread and records a gap beyond
``watchdog_timeout_s`` as a stall.  It observes only: it never stops a
computation on the card.
"""
from __future__ import annotations

import dataclasses
import shutil
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.resilience import faults, guards


class SupervisorAbort(RuntimeError):
    """Escalation exhausted; carries the structured ``report``."""

    def __init__(self, message: str, report: "SupervisorReport"):
        super().__init__(message)
        self.report = report


@dataclasses.dataclass(frozen=True)
class SupervisorConfig:
    """Escalation knobs: ``max_retries`` resumes a rollback level,
    ``max_rollbacks`` newest-checkpoint deletions before abort (0: none),
    ``watchdog_timeout_s`` the heartbeat gap that counts as a stall, and
    the backoff between attempts (jitter keyed on the plan's seed)."""

    max_retries: int = 2
    max_rollbacks: int = 1
    watchdog_timeout_s: float = 60.0
    backoff_base_s: float = 0.02
    backoff_factor: float = 2.0
    backoff_cap_s: float = 1.0


@dataclasses.dataclass
class SupervisorReport:
    """Structured diagnostic record of one supervised run."""

    status: str = "ok"                 # "ok" | "aborted"
    attempts: int = 0
    retries: int = 0
    rollbacks: int = 0
    attempt_log: List[Dict[str, Any]] = dataclasses.field(
        default_factory=list)
    faults_fired: List[Tuple[str, int, str]] = dataclasses.field(
        default_factory=list)
    faults_not_applicable: List[Tuple[str, int, str]] = dataclasses.field(
        default_factory=list)
    quarantined: List[int] = dataclasses.field(default_factory=list)
    stalls: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    events: List[Tuple[str, int, str]] = dataclasses.field(
        default_factory=list)
    error: Optional[str] = None

    def to_dict(self) -> Dict[str, Any]:
        """JSON-ready form."""
        return dataclasses.asdict(self)

    def summary(self) -> str:
        """Human-readable digest for the launcher's output."""
        lines = [f"supervisor: {self.status} after {self.attempts} "
                 f"attempt(s) ({self.retries} retries, "
                 f"{self.rollbacks} rollbacks)"]
        if self.faults_fired:
            lines.append("  faults fired: " + ", ".join(
                f"{k}@{s}" + (f" [{d}]" if d else "")
                for k, s, d in self.faults_fired))
        if self.faults_not_applicable:
            lines.append("  not applicable: " + ", ".join(
                f"{k}@{s} ({w})" for k, s, w in self.faults_not_applicable))
        if self.quarantined:
            lines.append(f"  quarantined shards: {self.quarantined}")
        if self.stalls:
            lines.append(f"  watchdog stalls: {len(self.stalls)}")
        if self.error:
            lines.append(f"  last error: {self.error}")
        return "\n".join(lines)


class Watchdog:
    """Heartbeat monitor on a daemon thread.

    ``beat(phase, step)`` is the producer (the ``ResilienceContext``'s
    heartbeat sink); the monitor records a stall when the gap since the
    last beat passes ``timeout_s``, once an episode (the next beat re-arms
    it).  Observation only.
    """

    def __init__(self, timeout_s: float = 60.0,
                 poll_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout_s = float(timeout_s)
        self._poll_s = poll_s if poll_s is not None \
            else max(min(timeout_s / 4.0, 1.0), 0.01)
        self._clock = clock
        self._lock = threading.Lock()
        self._last = (clock(), "start", -1)
        self._stalled = False
        self.stalls: List[Dict[str, Any]] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def beat(self, phase: str, step: int) -> None:
        """Record liveness (called from the training thread's hooks)."""
        with self._lock:
            self._last = (self._clock(), phase, step)
            self._stalled = False

    def check(self) -> None:
        """One monitor poll (exposed for deterministic tests)."""
        with self._lock:
            t, phase, step = self._last
            gap = self._clock() - t
            if gap > self.timeout_s and not self._stalled:
                self._stalled = True
                self.stalls.append({"phase": phase, "step": step,
                                    "stalled_for_s": round(gap, 3)})

    def _run(self) -> None:
        while not self._stop.wait(self._poll_s):
            self.check()

    def start(self) -> "Watchdog":
        """Start the monitor thread (idempotent)."""
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="resilience-watchdog", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        """Stop and join the monitor thread."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


# the errors that climb the ladder: injected faults, guard violations and
# the checkpoint layer's ValueErrors (torn or corrupt restores).  Anything
# else (a TypeError, ...) is a bug and passes straight through: retrying a
# deterministic programming error only burns compute.
RECOVERABLE = (faults.FaultError, guards.GuardError, ValueError)


def supervise(train_kwargs: Dict[str, Any], *,
              plan: Optional[faults.FaultPlan] = None,
              guard: Optional[guards.GuardConfig] = None,
              config: Optional[SupervisorConfig] = None,
              train_fn: Optional[Callable] = None,
              sleep: Callable[[float], None] = time.sleep
              ) -> Tuple[Any, SupervisorReport]:
    """Run ``loops.train(**train_kwargs)`` under supervision.

    ``train_kwargs`` are ``loops.train``'s keywords (``algo`` and
    ``env_name`` included); retry by resume and rollback need
    ``checkpoint_dir`` and ``checkpoint_every`` there, else a retry starts
    afresh (still bounded and reported).  Returns ``(TrainResult,
    SupervisorReport)``, or raises ``SupervisorAbort`` with the report.
    The ``FaultInjector`` of ``plan`` is shared by every attempt.
    """
    if train_fn is None:
        from repro_torch.rl import loops
        train_fn = loops.train
    cfg = config if config is not None else SupervisorConfig()
    injector = faults.FaultInjector(plan) if plan is not None else None
    seed = plan.seed if plan is not None else 0
    watchdog = Watchdog(timeout_s=cfg.watchdog_timeout_s).start()
    ctx = faults.ResilienceContext(injector, guard,
                                   on_heartbeat=watchdog.beat)
    report = SupervisorReport()
    kwargs = dict(train_kwargs)
    ckpt_dir = kwargs.get("checkpoint_dir")
    can_resume = bool(ckpt_dir) and kwargs.get("checkpoint_every", 0) > 0
    retries = 0
    try:
        while True:
            report.attempts += 1
            watchdog.beat("attempt", report.attempts)
            try:
                result = train_fn(**kwargs, resilience=ctx)
                report.status = "ok"
                return result, report
            except RECOVERABLE as e:
                report.error = f"{type(e).__name__}: {e}"
                report.attempt_log.append({"attempt": report.attempts,
                                           "error": report.error,
                                           "action": None})
                if retries < cfg.max_retries:
                    retries += 1
                    report.retries += 1
                    report.attempt_log[-1]["action"] = "retry"
                    if can_resume:
                        kwargs["resume"] = True
                    sleep(guards.backoff_delay(
                        retries - 1, base_s=cfg.backoff_base_s,
                        factor=cfg.backoff_factor, cap_s=cfg.backoff_cap_s,
                        seed=seed))
                    continue
                if report.rollbacks < cfg.max_rollbacks and can_resume:
                    # the newest checkpoint reproduces the failure (the
                    # poison was saved before the guard tripped): drop it
                    # and re-run from the step before with a fresh budget
                    step = _rollback_newest(ckpt_dir)
                    report.rollbacks += 1
                    retries = 0
                    report.attempt_log[-1]["action"] = \
                        f"rollback (dropped step {step})"
                    kwargs["resume"] = True
                    continue
                report.status = "aborted"
                report.attempt_log[-1]["action"] = "abort"
                raise SupervisorAbort(
                    f"training failed after {report.attempts} attempt(s), "
                    f"{report.retries} retries, {report.rollbacks} "
                    f"rollbacks: {report.error}", report) from e
    finally:
        watchdog.stop()
        report.stalls = list(watchdog.stalls)
        report.events = list(ctx.events)
        report.quarantined = list(ctx.quarantined)
        if injector is not None:
            report.faults_fired = list(injector.fired)
            report.faults_not_applicable = list(injector.not_applicable)


def _rollback_newest(ckpt_dir: str) -> Optional[int]:
    """Delete the newest valid checkpoint step; returns its number."""
    from repro_torch.checkpoint import CheckpointManager
    mgr = CheckpointManager(ckpt_dir)
    step = mgr.latest_step()
    if step is not None:
        shutil.rmtree(mgr.step_path(step), ignore_errors=True)
    return step
