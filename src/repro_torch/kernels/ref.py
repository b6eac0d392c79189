"""Plain PyTorch versions of the port's kernels, op for op.

Counterpart of ``repro/kernels/ref.py:23-90, 105-149``.  These are the
reference each CUDA kernel is held against (bitwise for the integer
GEMMs and the fake quantizer, within 1e-5 for the float attention), and
the path a CPU tensor takes.  CUDA has no integer ``matmul``, so the int32 accumulator is taken
in float64, which is exact here: ``|acc| <= 2**14 * K < 2**53`` for any K
the policies use (float32 would not be exact past 2**24, which K = 4096
exceeds), and its cast to int32 is exact while ``K < 2**17`` (the conv
actor's longest K is 102,400); the corrected bracket is int32 and wraps
as the kernel's does.  The float epilogue is separate torch ops, so nothing is fused
into an FMA: ``(x_scale * w_scale) * corr``, then ``+ bias``.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from repro_torch.core import affine


def fake_quant_ref(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Per-tensor affine quantize-dequantize over ``x``'s own range."""
    return affine.quantize_dequantize(
        x, affine.compute_affine_params(x, bits))


def fake_quant_with_range_ref(x: torch.Tensor, vmin: torch.Tensor,
                              vmax: torch.Tensor, bits: int) -> torch.Tensor:
    """Quantize-dequantize with a given scalar (vmin, vmax) range, first
    extended to 0.  Both divisions are by a tensor, so the card divides
    correctly rounded, as the CPU and the kernel do."""
    return affine.quantize_dequantize(
        x, affine.affine_params_from_range(vmin, vmax, bits))


def int8_matmul_ref(x_q: torch.Tensor, w_q: torch.Tensor,
                    x_scale: torch.Tensor, w_scale: torch.Tensor,
                    x_zero: torch.Tensor, w_zero: torch.Tensor
                    ) -> torch.Tensor:
    """Dequantized product of int8 operands, f32 ``(M, N)``.

    ``x_q`` (M, K) int8 with scalar ``x_scale``/``x_zero``; ``w_q`` (K, N)
    int8 with per-column ``w_scale``/``w_zero`` (N,).  Computes

        (x_scale * w_scale) * [x_q @ w_q - x_zero * sum_k w_q
                               - w_zero * sum_k x_q + K * x_zero * w_zero]

    with the bracket in int32.
    """
    k = x_q.shape[-1]
    acc = torch.matmul(x_q.to(torch.float64), w_q.to(torch.float64)
                       ).to(torch.int32)
    sum_w = w_q.to(torch.int32).sum(dim=0, dtype=torch.int32)        # (N,)
    sum_x = x_q.to(torch.int32).sum(dim=-1, keepdim=True,
                                    dtype=torch.int32)                # (M,1)
    xz = x_zero.to(torch.int32)
    wz = w_zero.to(torch.int32)[None, :]
    corr = acc - xz * sum_w[None, :] - wz * sum_x + k * xz * wz
    return x_scale * w_scale[None, :] * corr.to(torch.float32)


def fused_qmlp_ref(x_q: torch.Tensor, layers: Sequence) -> torch.Tensor:
    """Whole quantized MLP over int8 input codes (``fused_qmlp`` oracle).

    ``layers`` are ``fused_qmlp.QMLPLayer``.  Each layer is
    ``int8_matmul_ref`` + bias; hidden layers then apply ReLU and the
    static requant to the next layer's input params.  Only the head's f32
    output is returned.
    """
    h = x_q
    for i, layer in enumerate(layers):
        w = layer.codes
        if layer.bits <= 4:
            w = affine.unpack_int4(w, layer.k)
        y = int8_matmul_ref(h, w, layer.x_delta, layer.col_scale,
                            layer.x_zero, layer.col_zero)
        y = y + layer.bias
        if i + 1 == len(layers):
            return y
        nxt = layers[i + 1]
        h = affine.quantize_with_params(
            torch.relu(y), affine.AffineParams(nxt.x_delta, nxt.x_zero, 8))
    raise ValueError("fused_qmlp needs at least one layer")


NEG_INF = -1e30     # the reference's mask value (not -inf)


def int8_cache_decode_ref(q: torch.Tensor, k_codes: torch.Tensor,
                          k_scale: torch.Tensor, v_codes: torch.Tensor,
                          v_scale: torch.Tensor, pos: torch.Tensor,
                          window: Optional[int] = None) -> torch.Tensor:
    """Decode attention over an int8 KV cache, as a dense softmax.

    ``q (..., G, Dh)``; codes ``(..., T, Dh)`` int8 with ``(..., T, 1)``
    f32 scales; ``pos`` an int tensor of the leading dims' shape
    ``q.shape[:-2]``, or a scalar (one decode position per problem).  In
    the reference's order: dequantize K, ``q @ k.T``, times ``Dh ** -0.5``,
    mask slots ``> pos`` (and ``<= pos - window``) with ``-1e30``, softmax,
    ``@ v``.  Returns ``(..., G, Dh)`` in ``q``'s dtype.
    """
    k = k_codes.to(torch.float32) * k_scale
    v = v_codes.to(torch.float32) * v_scale
    t = k.shape[-2]
    s = torch.matmul(q.to(torch.float32), k.transpose(-1, -2)) \
        * (q.shape[-1] ** -0.5)
    idx = torch.arange(t, device=q.device)
    p = pos.to(device=q.device, dtype=torch.int64)[..., None, None]
    valid = idx <= p
    if window is not None:
        valid = valid & (idx > p - window)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    return torch.matmul(torch.softmax(s, dim=-1), v).to(q.dtype)


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool = True, window: Optional[int] = None,
            softcap: Optional[float] = None,
            scale: Optional[float] = None,
            q_offset: Optional[int] = None) -> torch.Tensor:
    """Dense reference attention, one head: ``q (S, D)``, ``k/v (T, D)``.

    Leading dims broadcast (a batch of heads).  Query positions are
    aligned to the end of the kv axis (``q_pos = i + T - S``), or start at
    ``q_offset`` where it is given; ``window``
    keeps keys in ``(q_pos - window, q_pos]``; ``softcap`` is gemma2's
    ``softcap * tanh(s / softcap)``.  Masked logits are ``-inf``, and a
    fully masked row gives 0, as the reference's ``mha_ref`` does.  The
    default scale is ``1 / sqrt(D)``.
    """
    s, d = q.shape[-2:]
    t = k.shape[-2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = torch.matmul(q.to(torch.float32),
                          k.to(torch.float32).transpose(-1, -2)) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    mask = attention_mask(s, t, causal=causal, window=window,
                          device=q.device, q_offset=q_offset)
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    probs = torch.where(torch.isnan(probs), 0.0, probs)  # fully masked rows
    return torch.matmul(probs, v.to(torch.float32)).to(q.dtype)


def attention_mask(s: int, t: int, *, causal: bool, window: Optional[int],
                   device=None, q_offset: Optional[int] = None
                   ) -> torch.Tensor:
    """``(S, T)`` boolean: which keys each query sees, query i at key
    position ``i + q_offset`` (None: aligned to the end of the kv
    axis, ``T - S``)."""
    off = t - s if q_offset is None else q_offset
    q_pos = torch.arange(s, device=device)[:, None] + off
    k_pos = torch.arange(t, device=device)[None, :]
    mask = (k_pos <= q_pos) if causal else torch.ones(
        (s, t), dtype=torch.bool, device=device)
    if window is not None:
        mask = mask & (k_pos > q_pos - window)
    return mask
