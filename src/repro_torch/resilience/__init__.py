"""Self-healing ActorQ runtime: fault injection, guards, supervision.

Counterpart of ``repro.resilience``, in three modules:

* ``faults``     -- deterministic seeded fault injection (``FaultPlan``)
  and the ``ResilienceContext`` hook object ``loops.train(resilience=...)``
  takes;
* ``guards``     -- typed integrity, numerical and structural guards:
  CRC'd packed-cache pushes, one-sync finite checks, int8/int4 cache
  validation;
* ``supervisor`` -- the retry -> rollback -> abort escalation with a
  heartbeat watchdog (re-exported lazily below: it imports ``rl.loops``,
  which imports nothing of this package).
"""
from repro_torch.resilience.faults import (ActorCrashError, FaultError,
                                           FaultInjector, FaultPlan,
                                           FaultSpec, ResilienceContext,
                                           bitflip_tree, poison_params)
from repro_torch.resilience.guards import (CodeRangeError, GuardConfig,
                                           GuardError, IntegrityError,
                                           NonFiniteError, all_finite,
                                           check_finite, tree_crc32,
                                           validate_cache, verify_crc)

_SUPERVISOR = ("supervise", "SupervisorAbort", "SupervisorConfig",
               "SupervisorReport", "Watchdog")

__all__ = [
    "ActorCrashError", "FaultError", "FaultInjector", "FaultPlan",
    "FaultSpec", "ResilienceContext", "bitflip_tree", "poison_params",
    "CodeRangeError", "GuardConfig", "GuardError", "IntegrityError",
    "NonFiniteError", "all_finite", "check_finite", "tree_crc32",
    "validate_cache", "verify_crc", *_SUPERVISOR,
]


def __getattr__(name):
    """Lazy re-export of the supervisor layer."""
    if name in _SUPERVISOR:
        from repro_torch.resilience import supervisor
        return getattr(supervisor, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
