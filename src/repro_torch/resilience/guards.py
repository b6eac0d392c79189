"""Integrity and numerical guards for the self-healing ActorQ runtime.

Counterpart of ``repro/resilience/guards.py``.  Three guard families,
each raising a *typed* error instead of letting a fault corrupt training
silently:

* **Integrity** -- ``tree_crc32`` checksums a packed actor cache (codes
  and scales, every tensor in flatten order) so a param push can be
  verified at the consumer: ``verify_crc`` raises ``IntegrityError`` on
  any bit difference.
* **Numerical** -- ``all_finite`` is one reduction over the float leaves
  of a tree, left on their device; ``check_finite`` reads it back with
  one host sync and raises ``NonFiniteError`` naming the offending leaves
  (found only on failure).
* **Structural** -- ``validate_cache`` checks the quantizer invariants of
  a packed int8/int4 cache and raises ``CodeRangeError``.  Scale
  corruption is caught there even without a reference CRC; code bit
  flips need the integrity guard (every int8 byte is a valid code).

``GuardConfig`` bundles the knobs the training drivers and the
supervisor read (``resilience.faults.ResilienceContext``).
"""
from __future__ import annotations

import dataclasses
import time
import zlib
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.core.ptq import (PackedTensor, tree_flatten, tree_map,
                                  tree_tensors)


class GuardError(RuntimeError):
    """Base class for guard violations (typed, never a bare assert)."""


class IntegrityError(GuardError):
    """A packed payload's checksum does not match its content."""


class NonFiniteError(GuardError):
    """NaN/Inf found in params/updates that must be finite."""


class CodeRangeError(GuardError):
    """Packed int8/int4 cache violates the quantizer invariants."""


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    """Guard knobs threaded through the drivers and the supervisor.

    ``check_finite`` -- finite-params check on the learner after update
    rounds; ``verify_pushes`` -- CRC/repack verification of packed param
    pushes; ``validate_codes`` -- structural cache validation alongside
    the push guard; ``check_every`` -- host-sync cadence in driver rounds
    (1 = every round); ``push_retries`` -- bounded retries of a failed
    (corrupted) push before the typed error escalates;
    ``backoff_base_s`` / ``backoff_factor`` / ``backoff_cap_s`` -- the
    exponential backoff of those retries (deterministic jitter, see
    ``backoff_delay``).
    """

    check_finite: bool = True
    verify_pushes: bool = True
    validate_codes: bool = True
    check_every: int = 1
    push_retries: int = 2
    backoff_base_s: float = 0.01
    backoff_factor: float = 2.0
    backoff_cap_s: float = 0.5


def deterministic_jitter(seed: int, attempt: int) -> float:
    """Jitter fraction in [0, 1) as a pure function of (seed, attempt):
    CRC32 over the pair's little-endian bytes, so a chaos run's retry
    timing repeats exactly."""
    h = zlib.crc32(int(seed).to_bytes(8, "little", signed=True)
                   + int(attempt).to_bytes(8, "little", signed=True))
    return (h & 0xFFFFFFFF) / 2 ** 32


def backoff_delay(attempt: int, *, base_s: float, factor: float,
                  cap_s: float, seed: int = 0) -> float:
    """``base * factor**attempt * (1 + jitter)`` clipped to ``cap_s``,
    the jitter ``deterministic_jitter(seed, attempt)``."""
    raw = base_s * (factor ** max(attempt, 0))
    return min(raw * (1.0 + deterministic_jitter(seed, attempt)), cap_s)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def tree_crc32(tree: Any) -> int:
    """CRC32 over every tensor's bytes + dtype/shape, in flatten order.

    Copies each tensor to the host on the current stream: call it off the
    hot path (pushes, hot-swaps), after the stream that wrote the tree.
    """
    crc = 0
    for _, t in tree_tensors(tree):
        arr = _host(t)
        crc = zlib.crc32(str((arr.dtype.str, arr.shape)).encode(), crc)
        crc = zlib.crc32(np.ascontiguousarray(arr).tobytes(), crc)
    return crc & 0xFFFFFFFF


def verify_crc(tree: Any, expected: int, *, what: str = "payload") -> None:
    """Raise ``IntegrityError`` unless ``tree_crc32(tree) == expected``."""
    got = tree_crc32(tree)
    if got != int(expected):
        raise IntegrityError(
            f"{what}: checksum mismatch -- expected {int(expected):#010x}, "
            f"got {got:#010x} (corrupted packed payload; refusing to "
            f"serve/sync it)")


def _float_leaves(tree: Any) -> List[torch.Tensor]:
    return [t for _, t in tree_tensors(tree) if t.is_floating_point()]


def all_finite(tree: Any) -> torch.Tensor:
    """0-d bool tensor: every float leaf all-finite.

    One ``isfinite(...).all()`` over the float leaves concatenated, on
    their device (one reduction a device when they span several); no host
    sync.  Integer leaves (codes, counters) are skipped.
    """
    by_device = {}
    for t in _float_leaves(tree):
        by_device.setdefault(t.device, []).append(t.reshape(-1))
    if not by_device:
        return torch.ones((), dtype=torch.bool)
    oks = [torch.isfinite(torch.cat(ts)).all()
           for ts in by_device.values()]
    ok = oks[0]
    for o in oks[1:]:
        ok = ok & o.to(ok.device)
    return ok


def nonfinite_paths(tree: Any, limit: int = 8) -> List[str]:
    """Paths (``core.ptq.tree_flatten``'s, e.g. ``['fc0']['w']``) of the
    float leaves holding NaN/Inf; one host sync a leaf, so for diagnosis
    only."""
    bad = []
    for path, leaf in zip(*tree_flatten(tree)):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point() \
                and not bool(torch.isfinite(leaf).all()):
            bad.append(path)
            if len(bad) >= limit:
                break
    return bad


def check_finite(tree: Any, *, what: str = "params") -> None:
    """Host-side finite guard: one host sync on ``all_finite``; on
    failure ``NonFiniteError`` naming the leaves."""
    if bool(all_finite(tree)):
        return
    bad = nonfinite_paths(tree)
    raise NonFiniteError(
        f"{what}: non-finite values in {len(bad)} leaf/leaves "
        f"(NaN/Inf gradient or corrupted update): {', '.join(bad)}")


def validate_cache(cache: Any, *, what: str = "actor cache") -> None:
    """Structural validation of a packed int8/int4 actor cache.

    Per ``PackedTensor``: integer codes, ``bits`` in [1, 16], codes inside
    the ``bits`` range (unpacked caches), packed int4 payloads sized to
    ``orig_shape``, finite zero points and columns, finite strictly
    positive ``delta``.  Other float entries (biases, static activation
    params) must be finite.  Raises ``CodeRangeError`` at the first
    violation.
    """
    packed: List[PackedTensor] = []
    rest = tree_map(lambda x: packed.append(x)
                    if isinstance(x, PackedTensor) else x, cache)
    for i, p in enumerate(packed):
        codes = _host(p.codes)
        if not np.issubdtype(codes.dtype, np.integer):
            raise CodeRangeError(f"{what}: packed leaf {i} codes dtype "
                                 f"{codes.dtype} is not an integer type")
        if not 1 <= int(p.bits) <= 16:
            raise CodeRangeError(
                f"{what}: packed leaf {i} bits={p.bits} outside [1, 16]")
        if p.orig_shape is None and int(p.bits) < 16:
            lo, hi = -(2 ** (p.bits - 1)), 2 ** (p.bits - 1) - 1
            cmin, cmax = int(codes.min()), int(codes.max())
            if cmin < lo or cmax > hi:
                raise CodeRangeError(
                    f"{what}: packed leaf {i} codes [{cmin}, {cmax}] exceed "
                    f"the {p.bits}-bit range [{lo}, {hi}]")
        if p.orig_shape is not None:
            k = int(np.prod(p.orig_shape[:-1]))
            want = ((k + 1) // 2) * p.orig_shape[-1]
            if codes.size != want:
                raise CodeRangeError(
                    f"{what}: packed leaf {i} has {codes.size} packed bytes, "
                    f"orig_shape {p.orig_shape} needs {want}")
        for name in ("delta", "zero_point", "col_scale", "col_zero"):
            a = _host(getattr(p, name))
            if not np.all(np.isfinite(a)):
                raise CodeRangeError(f"{what}: packed leaf {i} {name} "
                                     f"contains NaN/Inf (corrupted "
                                     f"quantizer scales)")
            if name == "delta" and not np.all(a > 0):
                raise CodeRangeError(
                    f"{what}: packed leaf {i} delta must be strictly "
                    f"positive, min={float(a.min())}")
    bad = nonfinite_paths(rest)
    if bad:
        raise CodeRangeError(f"{what}: non-finite float entries outside the "
                             f"packed weights: {', '.join(bad)}")


def retry_call(fn, *, retries: int, base_s: float, factor: float,
               cap_s: float, seed: int = 0, retry_on=Exception,
               on_retry=None, sleep=None):
    """Bounded retry with deterministic-jitter exponential backoff.

    Calls ``fn()`` up to ``retries + 1`` times; on a ``retry_on``
    exception runs ``on_retry(attempt, exc)``, sleeps
    ``backoff_delay(attempt, ...)`` and tries again.  The last failure is
    re-raised unchanged.  ``sleep`` is injectable for tests.
    """
    do_sleep = time.sleep if sleep is None else sleep
    attempt = 0
    while True:
        try:
            return fn()
        except retry_on as e:
            if attempt >= retries:
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            do_sleep(backoff_delay(attempt, base_s=base_s, factor=factor,
                                   cap_s=cap_s, seed=seed))
            attempt += 1


def checksum_entry(cache: Any) -> int:
    """``tree_crc32`` under the name of its call sites: the CRC a cache
    about to be published carries (``serving.CacheEntry.crc32``)."""
    return tree_crc32(cache)


def verify_or_none(cache: Any, crc: Optional[int], *, what: str) -> None:
    """``verify_crc`` that tolerates a missing checksum."""
    if crc is not None:
        verify_crc(cache, crc, what=what)
