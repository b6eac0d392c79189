"""Integrity and structural guards of a packed actor cache (subset).

Counterpart of ``repro/resilience/guards.py:108-250``, the part
``serving.PolicyServer.push_params`` uses:

* ``tree_crc32`` / ``verify_crc`` -- a CRC32 over every tensor's bytes,
  dtype and shape, in flatten order; ``IntegrityError`` on a mismatch.
* ``validate_cache`` -- the quantizer invariants of a packed cache
  (integer codes in range, finite strictly positive scales, finite zero
  points and columns, packed sizes consistent); ``CodeRangeError``.
"""
from __future__ import annotations

import zlib
from typing import Any, List

import numpy as np
import torch

from repro_torch.core.ptq import PackedTensor, tree_map, tree_tensors


class GuardError(RuntimeError):
    """Base class for guard violations (typed, never a bare assert)."""


class IntegrityError(GuardError):
    """A packed payload's checksum does not match its content."""


class CodeRangeError(GuardError):
    """Packed int8/int4 cache violates the quantizer invariants."""


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def tree_crc32(tree: Any) -> int:
    """CRC32 over every tensor's bytes + dtype/shape, in flatten order.

    Copies each tensor to the host: call it off the hot path (pushes).
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
            f"serve it)")


def _nonfinite_paths(tree: Any) -> List[str]:
    return [path for path, t in tree_tensors(tree)
            if t.is_floating_point() and not bool(torch.isfinite(t).all())]


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
    bad = _nonfinite_paths(rest)
    if bad:
        raise CodeRangeError(f"{what}: non-finite float entries outside the "
                             f"packed weights: {', '.join(bad)}")
