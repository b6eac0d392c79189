"""Public quantized ops: a CUDA tensor goes to the kernel, a CPU tensor to
the plain PyTorch version.

Counterpart of ``repro/kernels/ops.py:58-230``.  There is no
backend knob and no environment override: where the data lies decides, so
the card's path always runs the hand-written kernel (or raises) and the CPU
tests run the plain versions.

Two more cases, for the pod dry-run (``launch.steps.lower_step``):

* Shapes only.  Inputs that are ``FakeTensor``s (the dry-run's local
  shards) take no kernel and no plain version: the op returns empty
  outputs of the kernel's shapes and dtypes, reads no ``data_ptr``, and
  hands the kernel's operations and bytes (``PERF.md`` §6's bound
  formulas) to ``trace_sink`` when one is set.  A real tensor never takes
  this branch, and a ``meta`` tensor is refused as any other device's
  (the wrappers' contract since B4's port).
* DTensors.  The kernel runs on each rank's local shards through
  ``torch.distributed.tensor.experimental.local_map``, the inputs first
  redistributed to the layout the reference's constraints give at that
  site: B4's queries with the batch over ``data`` and, where the
  reference's chunked attention splits them, the query rows over
  ``model`` (``repro/models/attention.py:131-132, 167-173``), each shard
  then starting at its own query offset; B3's cache with its context
  gathered (the batch split kept); B1, B2 and B5 on replicated inputs.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.core import affine
from repro_torch.kernels import fake_quant as _fk
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fused_qmlp as _fq
from repro_torch.kernels import int8_cache_attention as _ca
from repro_torch.kernels import int8_matmul as _mm


#: ``trace_sink(kernel, operations, nbytes)``: called by the shape-only
#: branch of each kernel (``launch.trace_analysis`` sets it for a trace).
trace_sink: Optional[Callable[[str, float, float], None]] = None


def _device_type(t: torch.Tensor) -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel for device {t.device}")
    return t.device.type


def _shape_only(t: torch.Tensor) -> bool:
    """A fake tensor: the trace's shapes, no data."""
    return isinstance(t, FakeTensor)


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _account(kernel: str, ops: float, nbytes: float) -> None:
    if trace_sink is not None:
        trace_sink(kernel, float(ops), float(nbytes))


def _replicated(fn, *args):
    """``fn`` on replicated copies of its DTensor arguments, each output
    of the first DTensor argument's rank back in that argument's splits
    (a partial sum comes back whole; the B1, B2 and B5 sites: their
    per-tensor ranges and contractions read the whole tensor)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    first = next(a for a in args if isinstance(a, DTensor))
    mesh = first.device_mesh
    rep = [Replicate()] * mesh.ndim
    local = [a.redistribute(mesh, rep).to_local()
             if isinstance(a, DTensor) else a for a in args]
    out = fn(*local)
    outs = out if isinstance(out, tuple) else (out,)
    split = [p if isinstance(p, Shard) else Replicate()
             for p in first.placements]
    back = tuple(DTensor.from_local(o, mesh, rep, run_check=False)
                 .redistribute(mesh, split if o.dim() == first.dim()
                               else rep)
                 for o in outs)
    return back if isinstance(out, tuple) else back[0]


def fake_quant_with_range(x: torch.Tensor, vmin: torch.Tensor,
                          vmax: torch.Tensor, bits: int) -> torch.Tensor:
    """Quantize-dequantize ``x`` (f32, any shape) with the scalar range
    ``(vmin, vmax)`` -- 0-d f32 tensors on ``x``'s device -- extended to
    0 (kernel B5 on the card)."""
    if _is_dtensor(x):
        return _replicated(lambda *a: fake_quant_with_range(*a, bits),
                           x, vmin, vmax)
    if _shape_only(x):
        _account("fake_quant", 4 * x.numel(), 8 * x.numel())
        return torch.empty_like(x)
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
    if _is_dtensor(x):
        return _replicated(lambda *a: qat_activation_site(
            *a, quant_delay, ema_decay, bits), x, vmin, vmax, initialized,
            step)
    if _shape_only(x):
        _account("fake_quant", 4 * x.numel(), 8 * x.numel())
        return (torch.empty_like(x), torch.empty_like(vmin),
                torch.empty_like(vmax), torch.empty_like(initialized))
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
    if _is_dtensor(w):
        return _replicated(lambda *a: qat_weight_site(*a, quant_delay, bits),
                           w, step)
    if _shape_only(w):
        _account("fake_quant", 4 * w.numel(), 8 * w.numel())
        return torch.empty_like(w)
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
    if _is_dtensor(x_q):
        return _replicated(lambda *a: int8_matmul(*a, w_bits=w_bits),
                           x_q, w_q, x_scale, x_zero, w_scale, w_zero)
    if _shape_only(x_q):
        m, n = x_q.numel() // k, w_q.shape[-1]
        _account("int8_matmul", 2 * m * k * n,
                 x_q.numel() + w_q.numel() + 4 * m * n)
        return x_q.new_empty(tuple(x_q.shape[:-1]) + (n,),
                             dtype=torch.float32)
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
    if _is_dtensor(x):
        return _replicated(lambda a: fused_qmlp(a, layers), x)
    lead = x.shape[:-1]
    if _shape_only(x):
        m = x.numel() // x.shape[-1]
        _account("fused_qmlp",
                 sum(2 * m * max(l.k, 1) * l.n for l in layers),
                 m * x.shape[-1] + sum(l.codes.numel() for l in layers)
                 + 4 * m * layers[-1].n)
        return x.new_empty(tuple(lead) + (layers[-1].n,),
                           dtype=torch.float32)
    l0 = layers[0]
    x_q = affine.quantize_with_params(
        x.reshape(-1, x.shape[-1]),
        affine.AffineParams(l0.x_delta, l0.x_zero, 8)).contiguous()
    if _device_type(x_q) == "cuda":
        y = _fq.fused_qmlp_cuda(x_q, layers)
    else:
        y = _fq.fused_qmlp_plain(x_q, layers)
    return y.reshape(lead + y.shape[-1:])


@functools.lru_cache(maxsize=None)
def flash_pairs(s: int, t: int, causal: bool, window: Optional[int],
                q_offset: Optional[int] = None) -> int:
    """Unmasked (query, key) pairs of one head: query i at key position
    ``i + q_offset`` (None: ``T - S``).  numpy, not torch: a trace's fake
    mode would make torch's tensors fake."""
    q_pos = np.arange(s) + (t - s if q_offset is None else q_offset)
    hi = np.minimum(q_pos, t - 1) if causal else np.full(s, t - 1)
    lo = np.maximum(q_pos - window + 1, 0) if window else np.zeros(s, int)
    return int(np.maximum(hi - lo + 1, 0).sum())


def _seq_split(s: int, t: int) -> bool:
    """Where the reference's chunked attention puts its query chunks over
    ``model``: S above 2,048 in chunks of ``min(max(S // 16, 128),
    1024)`` rows, S and T whole numbers of chunks (T's of 1,024), and
    the chunks a multiple of 16 (``repro/models/attention.py:167,
    337-344``)."""
    qc = min(max(s // 16, 128), 1024)
    return (s > 2048 and s % qc == 0 and t % min(1024, t) == 0
            and (s // qc) % 16 == 0)


def _flash_local(q, k, v, causal, window, softcap, scale, q_offset):
    if _shape_only(q):
        b, s, h, d = q.shape
        t, kv = k.shape[1], k.shape[2]
        pairs = b * h * flash_pairs(s, t, causal, window, q_offset)
        _account("flash_attention", 4.0 * d * pairs,
                 4 * (2 * b * s * h * d + 2 * b * t * kv * d))
        return q.new_empty((b, s, h, d), dtype=torch.float32)
    if _device_type(q) == "cuda":
        return _fa.flash_attention_cuda(
            q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
            window=window, softcap=softcap, scale=scale, q_offset=q_offset)
    return _fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, scale=scale,
                                     q_offset=q_offset)


def _flash_layout(q, k):
    """B4's layout on DTensors: ``(q placements, K / V placements, this
    rank's query offset)``.  The batch over ``data`` where it divides
    (``local_map`` takes even splits) and, where the reference splits
    them, the query rows over ``model``; K and V gathered but for the
    batch."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = q.device_mesh
    names = mesh.mesh_dim_names
    s, t = q.shape[1], k.shape[1]
    split = _seq_split(s, t) and "model" in names
    kv_pl = [Shard(0) if n == "data" and q.shape[0] % mesh.size(i) == 0
             else Replicate() for i, n in enumerate(names)]
    q_pl = [Shard(1) if (n == "model" and split) else p
            for n, p in zip(names, kv_pl)]
    off = t - s
    if split:
        m = mesh.size(names.index("model"))
        off += mesh.get_local_rank("model") * -(-s // m)
    return q_pl, kv_pl, off


def _flash_dtensor(q, k, v, causal, window, softcap, scale):
    """B4 on DTensors, in ``_flash_layout`` (each shard of query rows at
    its own query offset)."""
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    q_pl, kv_pl, off = _flash_layout(q, k)

    def body(q_, k_, v_):
        return _flash_local(q_, k_, v_, causal, window, softcap, scale,
                            off)
    return local_map(body, out_placements=q_pl,
                     in_placements=(q_pl, kv_pl, kv_pl), device_mesh=mesh,
                     redistribute_inputs=True)(q, k, v)


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
    if _is_dtensor(q):
        return _flash_dtensor(q, k, v, causal, window, softcap, scale)
    return _flash_local(q, k, v, causal, window, softcap, scale, None)


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
        if _is_dtensor(q):
            return _flash_grad_dtensor(ctx, q, k, v, out, g) + (None,) * 4
        dq, dk, dv = _fa.dense_attention_grad(q, k, v, out, g, **ctx.kw)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None)


def _flash_grad_dtensor(ctx, q, k, v, out, g):
    """B4's backward on DTensors, shard by shard in the forward's layout
    (``_flash_layout``): each shard's query rows at its offset give their
    dq, and dK, dV as partial sums over the query split."""
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map
    q_pl, kv_pl, off = _flash_layout(q, k)
    dkv_pl = [Partial() if qp == Shard(1) else kp
              for qp, kp in zip(q_pl, kv_pl)]

    def body(q_, k_, v_, out_, g_):
        dq, dk, dv = _fa.dense_attention_grad(q_, k_, v_, out_, g_,
                                              q_offset=off, **ctx.kw)
        return dq.to(q_.dtype), dk.to(k_.dtype), dv.to(v_.dtype)
    return tuple(local_map(
        body, out_placements=(q_pl, dkv_pl, dkv_pl),
        in_placements=(q_pl, kv_pl, kv_pl, q_pl, q_pl),
        device_mesh=q.device_mesh, redistribute_inputs=True)(
            q, k, v, out, g))


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
    contract is ``0 <= pos < T``.  Returns ``(..., G, Dh)``.  On
    DTensors the cache's context (and head dim) is gathered first, the
    batch split kept (ROADMAP queue C: a merge of per-shard softmax
    statistics would move less).

    The cache is not copied: the last leading dim and the ones before it
    are the kernel's two problem levels, so a strided view such as the
    LM's ``(B, T, KV, Dh)`` cache transposed to ``(B, KV, T, Dh)`` is read
    where it lies (its head dim must have unit stride on the card).
    """
    if _is_dtensor(k_codes) or _is_dtensor(q):
        return _cache_dtensor(q, k_codes, k_scale, v_codes, v_scale, pos,
                              window)
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
    if _shape_only(q):
        r = args[0].shape[0] * nh
        _account("int8_cache_attention", 4.0 * r * g * t * dh,
                 r * t * (2 * dh + 8) + 2 * 4 * r * g * dh + 4 * r)
        return q.new_empty(q.shape, dtype=torch.float32)
    if _device_type(q) == "cuda":
        out = _ca.int8_cache_attention_cuda(*args, window=window)
    else:
        out = _ca.int8_cache_attention_plain(*args, window=window)
    return out.reshape(q.shape)


def _cache_dtensor(q, k_codes, k_scale, v_codes, v_scale, pos, window):
    """B3 on DTensors: each input with its leading (batch) dim's split
    kept where it is even and every other dim gathered."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    src = k_codes if isinstance(k_codes, DTensor) else q
    mesh = src.device_mesh
    pl = [p if p == Shard(0) and q.shape[0] % mesh.size(i) == 0
          else Replicate() for i, p in enumerate(src.placements)]
    if isinstance(pos, DTensor):
        pos = pos.full_tensor()

    def body(*a):
        return int8_cache_attention(*a, pos, window=window)
    return local_map(body, out_placements=pl, in_placements=(pl,) * 5,
                     device_mesh=mesh, redistribute_inputs=True)(
        *(a if isinstance(a, DTensor) else
          DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                             run_check=False).redistribute(mesh, pl)
          for a in (q, k_codes, k_scale, v_codes, v_scale)))
