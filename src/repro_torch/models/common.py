"""Parameter specs and the rms-norm of the port's models (the subset the
sequence policy needs).

Counterpart of ``repro/models/common.py:28-68, 138-145``.  A model
describes its parameters as a nested dict of ``P`` leaves (shape,
initializer, scale); ``init_params`` makes the tensors.  The reference's
logical sharding axes have no counterpart on one card, so ``P`` carries
none.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.device import resolve_device


class P(NamedTuple):
    """Spec of one parameter tensor."""

    shape: Tuple[int, ...]
    init: str = "normal"           # normal | zeros
    scale: Optional[float] = None  # None = fan-in 1 / sqrt(shape[-2])


def init_params(specs: Any, generator: torch.Generator,
                device=None) -> Any:
    """Tensors from a spec tree: normal draws times the leaf's scale (the
    reference's fan-in default), zeros for ``init="zeros"``.

    Leaves are drawn in sorted-key order from the CPU ``generator`` (so
    one seed gives the same params on every device), then moved to
    ``device`` (``None`` is ``cuda``).
    """
    device = resolve_device(device)

    def make(spec):
        if isinstance(spec, dict):
            return {k: make(spec[k]) for k in sorted(spec)}
        if spec.init == "zeros":
            return torch.zeros(spec.shape, device=device)
        if spec.init != "normal":
            raise ValueError(f"unknown init {spec.init!r}")
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        scale = spec.scale if spec.scale is not None \
            else 1.0 / math.sqrt(fan_in)
        return (torch.randn(spec.shape, generator=generator) * scale
                ).to(device)

    return make(specs)


def rms_norm(params: Dict[str, torch.Tensor], x: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x**2) + eps) * (1 + scale)`` over the last dim.

    Not bitwise across packages or devices: the mean's reduction order
    and ``rsqrt`` differ, by an ulp or so.
    """
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + params["scale"].to(torch.float32))).to(x.dtype)


def rms_norm_spec(d: int) -> Dict[str, P]:
    """The norm's gain, stored as ``scale`` and applied as ``1 + scale``
    (zero-initialized)."""
    return {"scale": P((d,), init="zeros")}
