"""Parameter specs and the primitive layers of the port's models.

Counterpart of ``repro/models/common.py``.  A model describes its
parameters as a nested dict of ``P`` leaves (shape, initializer, scale);
``init_params`` makes the tensors.  Layers are plain functions of
``(params, x)``, and ``dense`` threads the QAT context's weight and
activation hooks as the reference does.  The reference's logical sharding
axes, ``partition_specs`` and ``with_constraint`` have no counterpart on
one card, so ``P`` carries no axes.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.device import resolve_device


class P(NamedTuple):
    """Spec of one parameter tensor."""

    shape: Tuple[int, ...]
    init: str = "normal"           # normal | zeros | ones | embed
    scale: Optional[float] = None  # None = fan-in 1 / sqrt(shape[-2])


def init_params(specs: Any, generator: torch.Generator,
                device=None, dtype: torch.dtype = torch.float32) -> Any:
    """Tensors from a spec tree.

    ``normal``: normal draws times the leaf's scale (the reference's
    fan-in default ``1 / sqrt(shape[-2])``); ``embed``: normal draws times
    0.02; ``zeros`` and ``ones`` draw nothing.  Leaves are drawn in
    sorted-key order from ``generator``, on its device (a CPU generator
    gives the same params on every device; a CUDA one draws a large tree
    on the card), in float32, then cast to ``dtype`` (round to nearest
    even, as the reference's ``astype``) and moved to ``device``
    (``None`` is ``cuda``).
    """
    device = resolve_device(device)

    def make(spec):
        if isinstance(spec, dict):
            return {k: make(spec[k]) for k in sorted(spec)}
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dtype, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dtype, device=device)
        if spec.init == "embed":
            scale = 0.02
        elif spec.init == "normal":
            fan_in = spec.shape[-2] if len(spec.shape) >= 2 \
                else spec.shape[-1]
            scale = spec.scale if spec.scale is not None \
                else 1.0 / math.sqrt(fan_in)
        else:
            raise ValueError(f"unknown init {spec.init!r}")
        return torch.randn(spec.shape, generator=generator,
                           device=generator.device).mul_(scale).to(
                               device=device, dtype=dtype)

    return make(specs)


def stack_specs(specs: Any, n: int) -> Any:
    """Prepend a stacked ``layers`` axis of size ``n`` to every leaf."""
    if isinstance(specs, dict):
        return {k: stack_specs(v, n) for k, v in specs.items()}
    return P((n,) + tuple(specs.shape), specs.init, specs.scale)


# ---------------------------------------------------------------------------
# primitive layers
# ---------------------------------------------------------------------------

def dense(ctx, name: str, params: Dict[str, torch.Tensor], x: torch.Tensor,
          *, quant_act: bool = True) -> torch.Tensor:
    """``x @ W (+ b)`` with the QAT context's weight / activation hooks
    (the attention and MLP projections have no bias; the xLSTM gates
    do), the weight and bias cast to ``x``'s dtype as the reference's."""
    y = torch.matmul(x, ctx.weight(f"{name}/w", params["w"]).to(x.dtype))
    if "b" in params:
        y = y + params["b"].to(x.dtype)
    if quant_act:
        y = ctx.activation(f"{name}/out", y)
    return y


def dense_spec(d_in: int, d_out: int, *, bias: bool = False
               ) -> Dict[str, P]:
    """A ``(d_in, d_out)`` weight, fan-in scaled, and with ``bias`` a zero
    ``(d_out,)`` bias ``b``."""
    spec = {"w": P((d_in, d_out))}
    if bias:
        spec["b"] = P((d_out,), init="zeros")
    return spec


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


def layer_norm(params: Dict[str, torch.Tensor], x: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """``(x - mean) * rsqrt(var + eps) * scale + bias`` over the last dim
    (the biased variance, as ``jnp.var``)."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"] + params["bias"]).to(x.dtype)


def layer_norm_spec(d: int) -> Dict[str, P]:
    """Gain (ones) and bias (zeros)."""
    return {"scale": P((d,), init="ones"), "bias": P((d,), init="zeros")}


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     device=None) -> torch.Tensor:
    """``1 / theta ** (2i / head_dim)`` for ``i < head_dim / 2``, f32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotate halves of ``x (..., S, H, Dh)`` by ``positions`` (broadcast
    to ``(..., S)``), as the reference does (split halves, not
    interleaved pairs)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions.to(torch.float32)[..., None] * freqs   # (..., S, Dh/2)
    angles = angles[..., None, :]                              # head axis
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
