"""Kernel B3: decode attention over an int8 KV cache with per-token scales.

Replaces ``repro/kernels/int8_cache_attention.py:
int8_cache_decode_attention`` (Pallas kernel ``_kernel``).  The CUDA
source is ``csrc/int8_cache_attention.cu``; its header note says what
bounds it on the H100 (the bytes of the cache slots it reads) and how the
design answers: a split path (one block per problem and key split with
all G query heads in it, the slots streamed through a ``cp.async`` ring,
the splits merged by the last block to arrive) and a small path for the
sequence actor's few-slot windows, both reading the cache where it lies.
``plan`` gives the launch's shape, and picks the path, as plain
arithmetic.

Both functions take a problem index of one or two levels: ``q (R, G,
Dh)`` against codes ``(R, T, Dh)``, or ``q (NB, NH, G, Dh)`` against
codes ``(NB, NH, T, Dh)`` (the LM's ``(B, T, KV, Dh)`` cache seen through
``transpose(1, 2)``, read in place); int8 codes, f32 scales ``(..., T,
1)``, and ``pos`` of the leading shape, int32, one decode position per
problem with ``0 <= pos < T``.  ``int8_cache_attention_cuda`` launches the
kernel on the current stream and counts the launch in ``launches``;
``int8_cache_attention_plain`` is the same function in plain PyTorch
(``ref.int8_cache_decode_ref``, a dense softmax): the CPU path, and what
the kernel is held against on the card, within 1e-5.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build, ref

launches = build.LaunchCounter("int8_cache_attention")
# csrc/int8_cache_attention.cu: MAX_DH, MAX_G, THREADS, TS, STAGES, WARPS,
# SMALL
MAX_DH, MAX_G = 256, 16
THREADS, TILE, STAGES, WARPS, SMALL = 256, 128, 4, 8, 32
SMS = 132                       # H100 SXM streaming multiprocessors
SMEM_LIMIT = 232448             # H100: dynamic shared memory per block
BLOCKS_PER_SM = 2               # blocks an SM keeps in flight at a split
MAX_SPLITS = 32                 # splits taken for parallelism alone
PER_MAX = 1024                  # slots a split at most (scores in smem)
_VP, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_counts: Dict[Tuple[int, int], torch.Tensor] = {}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("int8_cache_attention")
    fn = lib.repro_int8_cache_attention
    fn.argtypes = [_VP] * 9 + [_I] * 9 + [_L] * 8 + [ctypes.c_float, _VP]
    fn.restype = _I
    lib.repro_int8_cache_attention_smem.argtypes = [_I] * 4
    lib.repro_int8_cache_attention_smem.restype = _I
    return lib


def kernel_smem(g: int, dh: int, per: int, splits: int) -> int:
    """The built kernel's dynamic shared-memory bytes for ``g`` query
    heads of head dim ``dh`` and ``splits`` splits of ``per`` slots (what
    ``plan`` mirrors; built on first use)."""
    return _lib().repro_int8_cache_attention_smem(g, dh, per, splits)


def _smem(g: int, dh: int, per: int, splits: int) -> int:
    """csrc: smem_bytes (the split path's dynamic shared memory)."""
    def align16(x):
        return -(-x // 16) * 16
    w = -(-dh // 4)
    row_bytes = 4 * (w + (4 - w) % 8)
    cap = -(-per // TILE) * TILE
    gm = next(x for x in (1, 2, 4, 8, MAX_G) if g <= x)
    ring = min(STAGES, 2 * cap // TILE) * min(TILE, per) * row_bytes
    merge = 20 * max(g * w, THREADS) if splits > 1 else 0
    region0 = align16(max(ring, (THREADS // w) * g * 4 * w * 4, merge))
    return region0 + 4 * (2 * cap + cap * gm + g * 4 * w
                          + 2 * WARPS * MAX_G + 2 * MAX_G)


@functools.lru_cache(maxsize=256)
def plan(r: int, g: int, t: int, dh: int,
         window: Optional[int] = None) -> dict:
    """The kernel's launch shape for ``r`` problems of ``g`` query heads
    over ``t`` slots of head dim ``dh``, mirroring the CUDA source.

    A problem reads at most ``min(t, window)`` slots.  Where the ``r``
    problems alone leave the card's SMs short of ``BLOCKS_PER_SM`` blocks
    each, those slots are split into ``splits`` chunks of ``per`` slots
    (whole tiles of ``TILE``), up to ``MAX_SPLITS``; and a chunk never
    holds more than ``PER_MAX`` slots, or more than the block's shared
    memory takes.  The chunks start at the window's first slot.  With
    ``splits > 1`` the launch needs ``scratch`` bytes of partials and
    ``r`` arrival counters.  A problem of at most ``SMALL`` slots (the
    sequence actor's window) takes the small path instead: one block a
    problem, one warp a slot, no split.
    """
    n_max = min(t, window) if window else t
    per_max = PER_MAX
    while True:
        splits = max(-(-n_max // per_max),
                     min(BLOCKS_PER_SM * SMS // r, n_max // TILE,
                         MAX_SPLITS))
        per = n_max
        if splits > 1:
            chunk = -(-n_max // splits)
            per = -(-chunk // TILE) * TILE
            splits = -(-n_max // per)
        smem = _smem(g, dh, per, splits)
        if smem <= SMEM_LIMIT - 16 or per_max <= TILE:
            break
        per_max //= 2
    if smem > SMEM_LIMIT - 16:
        raise ValueError(f"int8_cache_attention: {n_max} slots of G {g}, "
                         f"Dh {dh} need {splits} splits of {smem} bytes")
    if splits == 1 and per <= SMALL:
        return dict(path="small", splits=1, per=per, blocks=r,
                    threads=THREADS, smem=0, scratch=0)
    return dict(path="split", splits=splits, per=per, tile=TILE,
                tiles=-(-per // TILE), blocks=r * splits,
                stages=min(STAGES, 2 * -(-per // TILE)),
                threads=THREADS, smem=smem,
                scratch=(4 * r * splits * g * (2 + 4 * -(-dh // 4))
                         if splits > 1 else 0))


def int8_cache_attention_plain(q: torch.Tensor, k_codes: torch.Tensor,
                               k_scale: torch.Tensor, v_codes: torch.Tensor,
                               v_scale: torch.Tensor, pos: torch.Tensor,
                               window: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device and layout."""
    return ref.int8_cache_decode_ref(q, k_codes, k_scale, v_codes, v_scale,
                                     pos, window)


def _arrival_counts(dev: torch.device, stream: int, n: int) -> torch.Tensor:
    """Zeroed int32 counters for ``n`` problems, one buffer per device and
    stream.  The kernel's merging blocks set them back to 0, so a launch
    finds them zero without a memset; launches on one stream run in
    order, so they never share a counter at once."""
    key = (dev.index, stream)
    buf = _counts.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=dev)
        _counts[key] = buf
    return buf


def _strides(t: torch.Tensor) -> Tuple[int, ...]:
    """Strides with those of size-1 dims set to 0 (never stepped)."""
    return tuple(0 if n == 1 else s for n, s in zip(t.shape, t.stride()))


def _vec(dh: int, ptrs, strides) -> int:
    """Bytes a copy instruction moves: the largest of 16, 8, 4 that divides
    the head dim, the code strides and pointers, else 1."""
    return next((v for v in (16, 8, 4)
                 if all(x % v == 0 for x in (dh, *ptrs, *strides))), 1)


def int8_cache_attention_cuda(q: torch.Tensor, k_codes: torch.Tensor,
                              k_scale: torch.Tensor, v_codes: torch.Tensor,
                              v_scale: torch.Tensor, pos: torch.Tensor,
                              window: Optional[int] = None) -> torch.Tensor:
    """Launch the CUDA kernel: queries ``(R, G, Dh)`` or ``(NB, NH, G,
    Dh)`` -> the same shape, f32.

    ``q`` is contiguous; the codes and scales may be any strided view
    whose head dim has unit stride (K and V alike), ``pos`` any view.
    ``pos`` is read on the card (no host sync).  Raises ``ValueError`` on
    what the kernel does not take (``Dh > 256``, ``G > 16``, a window
    below 1, wrong types, shapes or layouts) and ``RuntimeError`` if the
    launch fails.
    """
    dev = q.device
    if dev.type != "cuda" or q.dim() not in (3, 4) \
            or k_codes.dim() != q.dim():
        raise ValueError("int8_cache_attention_cuda takes (R, G, Dh) or "
                         "(NB, NH, G, Dh) CUDA queries and codes of the "
                         "same rank")
    if q.dim() == 3:
        out = int8_cache_attention_cuda(
            q[None], k_codes[None], k_scale[None], v_codes[None],
            v_scale[None], pos[None], window)
        return out[0]
    nb, nh, g, dh = q.shape
    t = k_codes.shape[2]
    if min(nb, nh, t) < 1 or not 1 <= g <= MAX_G \
            or not 1 <= dh <= MAX_DH:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, cache "
                         f"{tuple(k_codes.shape)} (Dh <= {MAX_DH}, G <= "
                         f"{MAX_G})")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    for x, name, dtype, shape in (
            (q, "q", torch.float32, (nb, nh, g, dh)),
            (k_codes, "k_codes", torch.int8, (nb, nh, t, dh)),
            (v_codes, "v_codes", torch.int8, (nb, nh, t, dh)),
            (k_scale, "k_scale", torch.float32, (nb, nh, t, 1)),
            (v_scale, "v_scale", torch.float32, (nb, nh, t, 1)),
            (pos, "pos", torch.int32, (nb, nh))):
        if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{name}: need a {dtype} tensor of shape "
                             f"{shape} on {dev}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    code_st, scale_st = _strides(k_codes), _strides(k_scale)
    if not q.is_contiguous() or code_st[3] not in (0, 1) \
            or _strides(v_codes) != code_st or _strides(v_scale) != scale_st:
        raise ValueError("q must be contiguous, the codes' head dim of unit "
                         "stride, and K and V laid out alike")
    p = plan(nb * nh, g, t, dh, window)
    vec = _vec(dh, (k_codes.data_ptr(), v_codes.data_ptr()), code_st[:3])
    lib = _lib()
    out = torch.empty((nb, nh, g, dh), dtype=torch.float32, device=dev)
    with build.on_device(dev) as stream:
        part = count = None
        if p["splits"] > 1:
            part = torch.empty(p["scratch"] // 4, dtype=torch.float32,
                               device=dev)
            count = _arrival_counts(dev, stream, nb * nh)
        err = lib.repro_int8_cache_attention(
            q.data_ptr(), k_codes.data_ptr(), k_scale.data_ptr(),
            v_codes.data_ptr(), v_scale.data_ptr(), pos.data_ptr(),
            out.data_ptr(), None if part is None else part.data_ptr(),
            None if count is None else count.data_ptr(), nb, nh, g, t, dh,
            0 if window is None else window, p["splits"], p["per"], vec,
            *code_st[:3], *scale_st[:3], *_strides(pos), dh ** -0.5, stream)
    if err:
        raise RuntimeError(f"int8_cache_attention launch failed: "
                           f"cudaError {err}")
    launches.add()
    return out
