"""Kernel B4: blockwise online-softmax (flash) attention, with GQA.

Replaces ``repro/kernels/flash_attention.py: flash_attention_pallas``
(Pallas kernel ``_flash_kernel``), which ``repro/kernels/ops.py:
flash_attention`` vmaps over batch and heads.  The CUDA source is
``csrc/flash_attention.cu``; its header note says what bounds it on the
H100 (operations at the prefill shapes: tensor-core operations, since
both products run on the TF32 tensor cores in 3xTF32 to hold the 1e-5
contract) and how the design answers (``wgmma`` fed by a producer
warpgroup through an mbarrier ring, the G query heads of a KV head in
one tile, key tiles outside the causal / window band skipped, and the key
axis split over a thread block cluster where the tiles cannot fill the
card).  ``plan`` gives the launch's shape as plain arithmetic.

Both functions take ``q (B, S, H, D)`` and ``k, v (B, T, KV, D)`` with
``H`` a multiple of ``KV``: query head ``h`` reads KV head ``h // (H //
KV)``, and K and V are never repeated.  Query positions are aligned to the
end of the kv axis.  ``flash_attention_cuda`` launches the kernel on the
current stream (query tiles x key splits, KV heads and batch in one
grid) and counts the launch in ``launches``; ``flash_attention_plain``
is the same function in plain PyTorch (``ref.mha_ref``, a dense
softmax, a few heads at a time): the CPU path, and what the kernel is
held against on the card, within 1e-5.  A fully masked query row is 0
in both, as in ``ref.mha_ref``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import build, ref

launches = build.LaunchCounter("flash_attention")
MAX_D = 256                     # csrc/flash_attention.cu: MAX_D
PLAIN_LOGITS = 1 << 28          # floats of dense logits per plain call
SMS = 132                       # H100 SXM streaming multiprocessors
SMEM_LIMIT = 232448             # H100: dynamic shared memory per block
MAX_CLUSTER = 8                 # the portable cluster size
MERGE_TILES = 4                 # a cluster merge costs about 4 key tiles
_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _padded_d(d: int) -> int:
    """csrc/flash_attention.cu: padded_d."""
    return next((p for p in (16, 32, 48, 64, 80) if d <= p), 256)


def plan(b: int, s: int, t: int, h: int, kv: int, d: int, *,
         causal: bool = True, window: Optional[int] = None,
         q_offset: Optional[int] = None) -> dict:
    """The kernel's launch shape for ``q (b, s, h, d)``, ``k/v (b, t, kv,
    d)``, mirroring ``csrc/flash_attention.cu: Shape``.

    Rows of a KV head are its ``s * G`` (query, head) pairs; a block takes
    ``bq`` of them.  Where the (tile, KV head, batch) blocks number fewer
    than the card's SMs, the key axis is split over a cluster of
    ``cluster`` blocks: of the sizes in 1, 2, 4, 8 (at least two key tiles
    a block) whose blocks fill the card, or else the largest, the one that
    minimises waves x (key tiles a block + ``MERGE_TILES``).  A size that
    leaves SMs idle is never taken where a larger one would fill them.
    """
    dp = _padded_d(d)
    wide = dp > 80
    nwg, bk, stages = (1, 16, 2) if wide else (2, 32, 3)
    bq = 64 * nwg
    g = h // kv
    tiles = -(-(s * g) // bq)
    items = b * kv * tiles
    # the key tiles of the last query tile, the longest under a causal mask
    off = t - s if q_offset is None else q_offset
    p_lo, p_hi = ((tiles - 1) * bq) // g + off, s - 1 + off
    k_hi = min(t - 1, p_hi) if causal else t - 1
    k_lo = max(0, p_lo - window + 1) if window else 0
    key_tiles = k_hi // bk - k_lo // bk + 1 if k_hi >= k_lo else 0
    cluster = 1
    if items < SMS:
        def cost(c):
            return -(-items * c // SMS) * (-(-key_tiles // c) + MERGE_TILES)
        sizes = [c for c in (1, 2, 4, MAX_CLUSTER)
                 if c == 1 or key_tiles >= 2 * c]
        cluster = min([c for c in sizes if items * c >= SMS]
                      or sizes[-1:], key=cost)
    q_floats = bq * (dp + 4) if wide else 2 * bq * dp
    smem = 4 * (stages * 4 * bk * dp + q_floats + 2 * bq) + 16 * stages
    return dict(d_padded=dp, consumers=nwg, bq=bq, bk=bk, stages=stages,
                tiles=tiles, key_tiles=key_tiles, cluster=cluster,
                blocks=items * cluster, smem=smem)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    fn = lib.repro_flash_attention
    fn.argtypes = [_VP] * 4 + [_I] * 8 + [_F, _F, _I, _I, _VP]
    fn.restype = _I
    lib.repro_flash_attention_shape.argtypes = [_I, _VP]
    lib.repro_flash_attention_shape.restype = None
    return lib


def kernel_shape(d: int) -> dict:
    """The built kernel's shared-memory bytes and query rows a block for
    head dim ``d`` (what ``plan`` mirrors; built on first use)."""
    out = (ctypes.c_int * 2)()
    _lib().repro_flash_attention_shape(d, ctypes.addressof(out))
    return dict(smem=out[0], bq=out[1])


def _scale(d: int, scale: Optional[float]) -> float:
    return 1.0 / math.sqrt(d) if scale is None else float(scale)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: Optional[int] = None,
                          softcap: Optional[float] = None,
                          scale: Optional[float] = None,
                          q_offset: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device.

    ``ref.mha_ref`` over the heads, a few at a time so the dense logits
    stay under ``PLAIN_LOGITS`` floats; each head reads its KV head by
    index.  Query row i sits at key position ``i + q_offset`` (None: ``T
    - S``, the end alignment).  Returns ``(B, S, H, D)`` float32.
    """
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = _scale(d, scale)
    qh = q.permute(0, 2, 1, 3)                     # (B, H, S, D)
    kh, vh = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    out = torch.empty((b, h, s, d), dtype=torch.float32, device=q.device)
    step = max(1, min(h, PLAIN_LOGITS // max(b * s * t, 1)))
    for h0 in range(0, h, step):
        heads = torch.arange(h0, min(h0 + step, h), device=q.device)
        out[:, h0:h0 + step] = ref.mha_ref(
            qh[:, heads], kh[:, heads // g], vh[:, heads // g],
            causal=causal, window=window, softcap=softcap,
            scale=scale, q_offset=q_offset).to(torch.float32)
    return out.permute(0, 2, 1, 3)


def _check(t: torch.Tensor, name: str, shape: tuple,
           device: torch.device) -> None:
    if t.device != device or t.dtype != torch.float32 \
            or not t.is_contiguous() or tuple(t.shape) != shape:
        raise ValueError(f"{name}: need a contiguous float32 tensor of "
                         f"shape {shape} on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device} (contiguous: "
                         f"{t.is_contiguous()})")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: Optional[int] = None,
                         softcap: Optional[float] = None,
                         scale: Optional[float] = None,
                         q_offset: Optional[int] = None) -> torch.Tensor:
    """Launch the CUDA kernel: ``(B, S, H, D)`` queries -> ``(B, S, H, D)``
    float32, query row i at key position ``i + q_offset`` (None: ``T -
    S``).

    Raises ``ValueError`` on what the kernel does not take (``D > 256``,
    ``H`` not a multiple of ``KV``, a window below 1, a soft-cap not above
    0, a type other than float32, a non-contiguous layout) and
    ``RuntimeError`` if the launch fails.
    """
    dev = q.device
    if dev.type != "cuda" or q.dim() != 4 or k.dim() != 4:
        raise ValueError("flash_attention_cuda takes (B, S, H, D) CUDA "
                         "queries and (B, T, KV, D) keys and values")
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    if min(b, s, h, t, kv) < 1 or h % kv or not 1 <= d <= MAX_D:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)} (D <= {MAX_D}, H a multiple "
                         f"of KV)")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be None or > 0, got {softcap}")
    _check(q, "q", (b, s, h, d), dev)
    _check(k, "k", (b, t, kv, d), dev)
    _check(v, "v", (b, t, kv, d), dev)
    lib = _lib()
    off = t - s if q_offset is None else int(q_offset)
    cluster = plan(b, s, t, h, kv, d, causal=causal, window=window,
                   q_offset=off)["cluster"]
    out = torch.empty((b, s, h, d), dtype=torch.float32, device=dev)
    with build.on_device(dev) as stream:
        err = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s,
            t, h, kv, d, int(causal), 0 if window is None else window,
            0.0 if softcap is None else softcap, _scale(d, scale), off,
            cluster, stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: cudaError {err}")
    launches.add()
    return out


def dense_attention_grad(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         out: torch.Tensor, g: torch.Tensor, *,
                         causal: bool = True, window: Optional[int] = None,
                         softcap: Optional[float] = None,
                         scale: Optional[float] = None,
                         q_offset: Optional[int] = None):
    """The gradient of dense softmax attention, ``(dq, dk, dv)`` float32.

    What the reference's training path differentiates
    (``repro/models/attention.py: dense_attention``, float32 logits,
    masked ones ``-1e30``), written in torch ops as autodiff derives it:
    the masked, soft-capped scores recomputed, ``p = softmax``, then ``dv
    = p^T g``, ``ds = p * (g v^T - rowsum(g * out))`` through the
    soft-cap's ``1 - tanh^2`` and the scale, ``dq = ds k``, ``dk = ds^T
    q``.  ``q, out, g (B, S, H, D)``, ``k, v (B, T, KV, D)``: query head
    ``h`` reads KV head ``h // G``, so K's and V's gradients are summed
    over the G heads of a group (K and V are never repeated).  Holds
    ``(B, H, S, T)`` float32 scores a few times over.
    """
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    g_ = h // kv
    scale = _scale(d, scale)
    f32 = torch.float32
    q5 = q.to(f32).reshape(b, s, kv, g_, d)
    k32, v32 = k.to(f32), v.to(f32)
    g5 = g.to(f32).reshape(b, s, kv, g_, d)
    mask = ref.attention_mask(s, t, causal=causal, window=window,
                              device=q.device, q_offset=q_offset)
    sc = torch.einsum("bqkgd,bskd->bkgqs", q5, k32) * scale
    tanh = None
    if softcap is not None:
        tanh = torch.tanh(sc / softcap)
        sc = softcap * tanh
    p = torch.softmax(sc.masked_fill_(~mask, -1e30), dim=-1)
    del sc
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, g5)
    rows = torch.sum(g5 * out.to(f32).reshape(b, s, kv, g_, d), dim=-1)
    ds = torch.einsum("bqkgd,bskd->bkgqs", g5, v32)
    ds = p.mul_(ds.sub_(rows.permute(0, 2, 3, 1)[..., None]))
    if tanh is not None:
        ds = ds * (1.0 - tanh * tanh)
        del tanh
    ds = ds * scale
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k32).reshape(b, s, h, d)
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, q5)
    return dq, dk, dv
