"""Public quantized ops: a CUDA tensor goes to the kernel, a CPU tensor to
the plain PyTorch version.

Counterpart of ``repro/kernels/ops.py:58-230``.  There is no
backend knob and no environment override: where the data lies decides, so
the card's path always runs the hand-written kernel (or raises) and the CPU
tests run the plain versions.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core import affine
from repro_torch.kernels import fake_quant as _fk
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fused_qmlp as _fq
from repro_torch.kernels import int8_cache_attention as _ca
from repro_torch.kernels import int8_matmul as _mm


def _device_type(t: torch.Tensor) -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel for device {t.device}")
    return t.device.type


def fake_quant_with_range(x: torch.Tensor, vmin: torch.Tensor,
                          vmax: torch.Tensor, bits: int) -> torch.Tensor:
    """Quantize-dequantize ``x`` (f32, any shape) with the scalar range
    ``(vmin, vmax)`` -- 0-d f32 tensors on ``x``'s device -- extended to
    0 (kernel B5 on the card)."""
    if _device_type(x) == "cuda":
        return _fk.fake_quant_cuda(x.contiguous(), vmin, vmax, bits)
    return _fk.fake_quant_plain(x, vmin, vmax, bits)


def qat_activation_site(x: torch.Tensor, vmin: torch.Tensor,
                        vmax: torch.Tensor, initialized: torch.Tensor,
                        step: torch.Tensor, quant_delay: int,
                        ema_decay: float, bits: int
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
    """One QAT activation site (``QATContext.activation``): observe ``x``
    into the state ``(vmin, vmax, initialized)`` while ``step <
    quant_delay``, then fake-quantize over the new range where ``step >=
    quant_delay`` and the state is initialized.  Returns ``(out, vmin',
    vmax', initialized')``; the state comes back in new tensors.  One
    launch of the site kernel on the card; the composition on the CPU."""
    if _device_type(x) == "cuda":
        return _fk.activation_site_cuda(x.contiguous(), vmin, vmax,
                                        initialized, step, quant_delay,
                                        ema_decay, bits)
    return _fk.activation_site_plain(x, vmin, vmax, initialized, step,
                                     quant_delay, ema_decay, bits)


def qat_weight_site(w: torch.Tensor, step: torch.Tensor, quant_delay: int,
                    bits: int) -> torch.Tensor:
    """One QAT weight site (``QATContext.weight``): ``w`` fake-quantized
    over its own range where ``step >= quant_delay``, else ``w``.  One
    launch of the site kernel on the card; the composition on the CPU."""
    if _device_type(w) == "cuda":
        return _fk.weight_site_cuda(w.contiguous(), step, quant_delay, bits)
    return _fk.weight_site_plain(w, step, quant_delay, bits)


def fake_quant(x: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Per-tensor quantize-dequantize over ``x``'s own range.

    The range is a torch reduction outside the kernel, as in the
    reference (``min(x)`` and ``max(x)``, extended to 0).
    """
    vmin = torch.clamp(x.amin(), max=0.0).to(torch.float32)
    vmax = torch.clamp(x.amax(), min=0.0).to(torch.float32)
    return fake_quant_with_range(x, vmin, vmax, bits)


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor,
                x_scale: torch.Tensor, x_zero: torch.Tensor,
                w_scale: torch.Tensor, w_zero: torch.Tensor, *,
                w_bits: int = 8) -> torch.Tensor:
    """``(M, K) int8 @ (K, N) int8 -> (M, N) f32`` with affine dequant.

    ``w_bits <= 4`` takes byte-packed int4 codes ``(ceil(K/2), N)``
    (``core.affine.pack_int4``).  A ``w_q`` whose rows do not match K for
    the given ``w_bits`` raises ``ValueError`` (an int4 cache passed as
    int8, or unpacked codes passed as int4, would compute garbage).
    """
    k = x_q.shape[-1]
    if w_bits <= 4:
        if w_q.shape[0] != (k + 1) // 2:
            raise ValueError(
                f"w_bits={w_bits} expects byte-packed codes of "
                f"{(k + 1) // 2} rows for K={k}, got {tuple(w_q.shape)}")
    elif w_q.shape[0] != k:
        raise ValueError(
            f"w_bits={w_bits} expects unpacked codes of {k} rows for "
            f"K={k}, got {tuple(w_q.shape)}; byte-packed int4 caches must "
            f"pass w_bits<=4")
    if _device_type(x_q) == "cuda":
        return _mm.int8_matmul_cuda(x_q, w_q, x_scale, x_zero, w_scale,
                                    w_zero, w_bits=w_bits)
    return _mm.int8_matmul_plain(x_q, w_q, x_scale, x_zero, w_scale, w_zero,
                                 w_bits=w_bits)


def fused_qmlp(x: torch.Tensor, layers: Sequence[_fq.QMLPLayer]
               ) -> torch.Tensor:
    """Whole-MLP quantized forward in one kernel launch.

    ``x`` is f32 with any leading batch dims; ``layers`` carry static
    activation params (``rl.actorq.calibrate_actor_cache``).  The input is
    quantized here with layer 0's params; every inter-layer activation
    then stays int8 inside the kernel and only the head is f32.
    """
    if not layers:
        raise ValueError("fused_qmlp needs at least one layer")
    if layers[0].k != x.shape[-1]:
        raise ValueError(f"layer 0 expects K={layers[0].k}, x has "
                         f"{x.shape[-1]}")
    lead = x.shape[:-1]
    l0 = layers[0]
    x_q = affine.quantize_with_params(
        x.reshape(-1, x.shape[-1]),
        affine.AffineParams(l0.x_delta, l0.x_zero, 8)).contiguous()
    if _device_type(x_q) == "cuda":
        y = _fq.fused_qmlp_cuda(x_q, layers)
    else:
        y = _fq.fused_qmlp_plain(x_q, layers)
    return y.reshape(lead + y.shape[-1:])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Multi-head attention with GQA (kernel B4 on the card).

    ``q (B, S, H, D)``, ``k/v (B, T, KV, D)`` with ``H`` a multiple of
    ``KV``; query head ``h`` attends with KV head ``h // (H // KV)``
    (the reference's caller repeats K and V instead).  Query positions are
    aligned to the end of the kv axis; ``window`` keeps keys in ``(p -
    window, p]``; ``softcap`` is gemma2's tanh soft-cap; ``scale``
    defaults to ``1 / sqrt(D)``.  Returns ``(B, S, H, D)`` float32, with
    a fully masked row 0.
    """
    if _device_type(q) == "cuda":
        return _fa.flash_attention_cuda(
            q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
            window=window, softcap=softcap, scale=scale)
    return _fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, scale=scale)


class FlashAttentionDenseGrad(torch.autograd.Function):
    """``flash_attention`` forward (kernel B4 on the card, its plain
    version on the CPU), backward the gradient of dense softmax attention
    (``flash_attention.dense_attention_grad``, torch ops), as the
    reference's training path differentiates ``dense_attention``.

    ``apply(q, k, v, causal, window, softcap, scale)``: q, k and v go to
    B4 in float32 and the output comes back in q's dtype (the reference's
    float32 logits and ``astype(q.dtype)``); the gradients come back in
    each input's dtype.  Saves q, k, v and the float32 output.
    """

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale):
        f32 = torch.float32
        out = flash_attention(q.to(f32), k.to(f32), v.to(f32),
                              causal=causal, window=window, softcap=softcap,
                              scale=scale)
        ctx.save_for_backward(q, k, v, out)
        ctx.kw = dict(causal=causal, window=window, softcap=softcap,
                      scale=scale)
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, g):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = _fa.dense_attention_grad(q, k, v, out, g, **ctx.kw)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None)


def int8_cache_attention(q: torch.Tensor, k_codes: torch.Tensor,
                         k_scale: torch.Tensor, v_codes: torch.Tensor,
                         v_scale: torch.Tensor, pos, *,
                         window: Optional[int] = None) -> torch.Tensor:
    """Single-token decode attention over an int8-coded KV cache.

    Innermost shapes: ``q (G, Dh)`` -- G query heads sharing one KV head
    -- against ``k_codes/v_codes (T, Dh)`` int8 and ``k_scale/v_scale (T,
    1)`` f32 (``core.affine.quantize_symmetric``).  Slots ``> pos`` (and,
    with ``window``, ``<= pos - window``) are masked out.  Leading dims
    are batch dims, the kernel's problems; ``pos`` is a scalar or has a
    leading prefix of them as its shape (one position shared, or ragged
    decode), and a ``pos`` of higher rank raises ``ValueError``.  The
    contract is ``0 <= pos < T``.  Returns ``(..., G, Dh)``.

    The cache is not copied: the last leading dim and the ones before it
    are the kernel's two problem levels, so a strided view such as the
    LM's ``(B, T, KV, Dh)`` cache transposed to ``(B, KV, T, Dh)`` is read
    where it lies (its head dim must have unit stride on the card).
    """
    pos = torch.as_tensor(pos, dtype=torch.int32, device=q.device)
    lead = tuple(q.shape[:-2])
    if pos.dim() > len(lead):
        raise ValueError(f"pos rank {pos.dim()} exceeds batch rank "
                         f"{len(lead)}")
    if tuple(pos.shape) != lead[:pos.dim()]:
        raise ValueError(f"pos shape {tuple(pos.shape)} is not a prefix "
                         f"of the batch dims {lead}")
    pos = pos.reshape(tuple(pos.shape) + (1,) * (len(lead) - pos.dim()))
    g, dh = q.shape[-2:]
    t = k_codes.shape[-2]
    nh = lead[-1] if lead else 1
    codes, scales = (-1, nh, t, dh), (-1, nh, t, 1)
    args = (q.reshape(-1, nh, g, dh).contiguous(),
            k_codes.reshape(codes), k_scale.reshape(scales),
            v_codes.reshape(codes), v_scale.reshape(scales),
            pos.expand(lead).reshape(-1, nh))
    if _device_type(q) == "cuda":
        out = _ca.int8_cache_attention_cuda(*args, window=window)
    else:
        out = _ca.int8_cache_attention_plain(*args, window=window)
    return out.reshape(q.shape)
