"""Paper-faithful uniform affine quantization (QuaRL Sec. 3.1), in torch.

Counterpart of ``repro/core/affine.py``.  For an n-bit quantizer over W:

    delta = (|min(W, 0)| + |max(W, 0)|) / 2**n
    z     = round(-min(W, 0) / delta)
    Q(W)  = clip(round(W / delta) + z, 0, 2**n - 1)
    D(q)  = delta * (q - z)

The range is divided by ``2**n`` (not ``2**n - 1``), exactly as the paper
and the reference do.  Every op here is a plain torch op in float32 with
round-half-to-even (``torch.round``), so codes and params agree with the
reference bit for bit on the same inputs.  The reference's CPU int-key
range trick is an XLA workaround and has no counterpart here: it is exact
for every finite float, and where it and ``amin`` / ``amax`` differ (the
sign of a -0.0 / 0.0 tie) the derived params do not.

Dense weights are quantized per tensor; conv kernels per output channel
(``axis``: the quantization axis is kept and every other axis reduced),
as the paper and the reference do.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class AffineParams(NamedTuple):
    """Quantizer parameters; ``delta`` and ``zero_point`` are f32 tensors."""

    delta: torch.Tensor
    zero_point: torch.Tensor   # integral value, stored as float
    bits: int


def affine_params_from_range(wmin: torch.Tensor, wmax: torch.Tensor,
                             bits: int) -> AffineParams:
    """Paper's delta/z from a (min, max) range, first extended to 0."""
    wmin = torch.clamp(wmin, max=0.0)
    wmax = torch.clamp(wmax, min=0.0)
    delta = (wmin.abs() + wmax.abs()) / (2.0 ** bits)
    # all-zero tensor: delta == 0; use 1.0 so Q(0) = z and D(z) = 0 exactly
    delta = torch.where(delta == 0.0, torch.ones_like(delta), delta)
    zero_point = torch.round(-wmin / delta)
    return AffineParams(delta=delta, zero_point=zero_point, bits=bits)


def compute_affine_params(w: torch.Tensor, bits: int,
                          axis: Optional[int] = None) -> AffineParams:
    """Per-tensor params over all of ``w`` (``axis=None``), or per-axis
    params: reduced over every axis but ``axis``, kept with size 1, so a
    conv kernel's ``(kh, kw, C_in, C_out)`` gives ``(1, 1, 1, C_out)``."""
    if axis is None:
        return affine_params_from_range(w.amin(), w.amax(), bits)
    axis = axis % w.dim()
    dims = tuple(i for i in range(w.dim()) if i != axis)
    return affine_params_from_range(w.amin(dim=dims, keepdim=True),
                                    w.amax(dim=dims, keepdim=True), bits)


def quantize(w: torch.Tensor, params: AffineParams) -> torch.Tensor:
    """W -> codes in [0, 2**bits - 1], kept in the float dtype of W."""
    q = torch.round(w / params.delta) + params.zero_point
    return torch.clamp(q, 0.0, 2.0 ** params.bits - 1.0)


def dequantize(q: torch.Tensor, params: AffineParams) -> torch.Tensor:
    """Codes (in a float dtype) -> ``delta * (q - z)``."""
    return params.delta * (q - params.zero_point)


def quantize_dequantize(w: torch.Tensor, params: AffineParams
                        ) -> torch.Tensor:
    """The paper's Q followed by D: the fake-quantization value map."""
    return dequantize(quantize(w, params), params)


def ptq_tensor(w: torch.Tensor, bits: int,
               axis: Optional[int] = None) -> torch.Tensor:
    """One-shot post-training quantize-dequantize of a tensor over its
    own range (Algorithm 1).  Per tensor it goes through
    ``kernels.ops.fake_quant`` (kernel B5 on the card); per axis it is
    plain torch on every device, as the reference computes it with jnp
    ops outside its kernel."""
    if axis is not None:
        return quantize_dequantize(w, compute_affine_params(w, bits, axis))
    from repro_torch.kernels import ops      # ops imports this module
    return ops.fake_quant(w, bits)


def fp16_quantize(w: torch.Tensor) -> torch.Tensor:
    """IEEE-754 fp16 round trip (the paper's Q_fp16)."""
    return w.to(torch.float16).to(w.dtype)


def _int_dtype(bits: int) -> torch.dtype:
    return torch.int8 if bits <= 8 else torch.int16


def quantize_to_int(w: torch.Tensor, bits: int, axis: Optional[int] = None
                    ) -> Tuple[torch.Tensor, AffineParams]:
    """Quantize into signed storage: codes ``q - 2**(bits-1)``.

    Returns the codes and the params (per tensor, or per ``axis``) with
    the zero point shifted by the same offset, so ``dequantize_from_int``
    needs no offset.
    """
    params = compute_affine_params(w, bits, axis)
    offset = 2.0 ** (bits - 1)
    q_signed = (quantize(w, params) - offset).to(_int_dtype(bits))
    return q_signed, AffineParams(params.delta, params.zero_point - offset,
                                  bits)


def dequantize_from_int(q: torch.Tensor, params: AffineParams
                        ) -> torch.Tensor:
    """``delta * (q - z)`` in float32."""
    return params.delta * (q.to(torch.float32) - params.zero_point)


def quantize_with_params(w: torch.Tensor, params: AffineParams
                         ) -> torch.Tensor:
    """Quantize with precomputed signed-storage params (static requant).

    With params from ``calibration_params`` of the same tensor this equals
    ``quantize_to_int(w, bits)[0]`` bit for bit.
    """
    half = 2.0 ** (params.bits - 1)
    q = torch.round(w / params.delta) + params.zero_point
    return torch.clamp(q, -half, half - 1.0).to(_int_dtype(params.bits))


def calibration_params(w: torch.Tensor, bits: int = 8) -> AffineParams:
    """Signed-storage activation params of a calibration batch.

    The params ``quantize_to_int`` would derive from ``w``, without
    quantizing: cached once per push, they replace the per-call dynamic
    min/max pass of the fused MLP path.
    """
    params = compute_affine_params(w, bits)
    offset = 2.0 ** (bits - 1)
    return AffineParams(params.delta, params.zero_point - offset, bits)


# ---------------------------------------------------------------------------
# Sub-8-bit storage: two int4 codes per int8 byte
# ---------------------------------------------------------------------------

def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """Pack signed int4 codes (int8 values in [-8, 7]) pairwise along K.

    Row ``2i`` goes to the low nibble and row ``2i+1`` to the high nibble
    of byte ``i``: ``(K, N) -> (ceil(K/2), N)`` int8.  An odd K is padded
    with a zero row; consumers mask rows ``>= K``.
    """
    if codes.shape[0] % 2:
        codes = torch.cat([codes, torch.zeros_like(codes[:1])])
    c = codes.to(torch.int16)
    byte = (c[0::2] & 0xF) | ((c[1::2] & 0xF) << 4)        # 0..255
    return byte.to(torch.uint8).view(torch.int8)


def unpack_int4(packed: torch.Tensor, k: int) -> torch.Tensor:
    """Inverse of ``pack_int4``: ``(ceil(K/2), N) -> (K, N)`` int8 codes."""
    p = packed.to(torch.int16)                 # sign-extended byte
    lo = ((p & 0xF) ^ 8) - 8                   # low nibble, sign-extended
    hi = p >> 4                                # arithmetic shift
    both = torch.stack([lo, hi], dim=1)        # (Kp, 2, ...)
    out = both.reshape((-1,) + tuple(packed.shape[1:]))
    return out[:k].to(torch.int8)


# ---------------------------------------------------------------------------
# Symmetric per-token quantizer (the KV-cache writer)
# ---------------------------------------------------------------------------

def quantize_symmetric(x: torch.Tensor, dim: int = -1
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-slice int8 quantization (the KV-cache token quantizer).

    Counterpart of ``repro/core/affine.py:208-233``.  Reduces ``|x|`` over
    ``dim`` (kept) and maps the slice onto [-127, 127] with ``scale =
    amax / 127``; an all-zero slice gets scale 1, so its codes are 0.
    Returns ``(codes int8, scale f32)``; dequantization is ``codes *
    scale``.  The division is correctly rounded and ``torch.round`` rounds
    half to even on the CPU and on the card alike, so the same ``x`` gives
    the same codes and scales on both, and the reference's bit for bit.
    ``127`` is a tensor on ``x``'s device, not a Python scalar: on the
    card, torch divides by a CPU scalar as a multiply by its reciprocal,
    which is not correctly rounded.
    """
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=dim, keepdim=True)
    scale = torch.where(amax == 0, torch.ones_like(amax),
                        amax / amax.new_full((), 127.0))
    codes = torch.clamp(torch.round(xf / scale), -127.0, 127.0)
    return codes.to(torch.int8), scale
