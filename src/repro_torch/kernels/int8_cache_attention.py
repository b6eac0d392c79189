"""Kernel B3: decode attention over an int8 KV cache with per-token scales.

Replaces ``repro/kernels/int8_cache_attention.py:
int8_cache_decode_attention`` (Pallas kernel ``_kernel``).  The CUDA
source is ``csrc/int8_cache_attention.cu``; its header note says what
bounds it on the H100 (the bytes of the cache slots it reads) and how the
design answers (one block per query row, only the window's slots read,
per-warp online softmax merged in shared memory).

Both functions here take the leading dims already flattened (``ops.
int8_cache_attention`` does that): ``q (R, G, Dh)``, codes ``(R, T, Dh)``
int8, scales ``(R, T, 1)`` f32 and ``pos (R,)`` int32, one decode position
per problem with ``0 <= pos < T``.  ``int8_cache_attention_cuda`` launches
the kernel on the current stream and counts the launch in ``launches``;
``int8_cache_attention_plain`` is the same function in plain PyTorch
(``ref.int8_cache_decode_ref``, a dense softmax): the CPU path, and what
the kernel is held against on the card, within 1e-5.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build, ref

launches = build.LaunchCounter("int8_cache_attention")
MAX_DH = 256                    # csrc/int8_cache_attention.cu: MAX_DH
_VP, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("int8_cache_attention")
    fn = lib.repro_int8_cache_attention
    fn.argtypes = [_VP] * 7 + [_I] * 5 + [ctypes.c_float, _VP]
    fn.restype = _I
    return lib


def int8_cache_attention_plain(q: torch.Tensor, k_codes: torch.Tensor,
                               k_scale: torch.Tensor, v_codes: torch.Tensor,
                               v_scale: torch.Tensor, pos: torch.Tensor,
                               window: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device."""
    return ref.int8_cache_decode_ref(q, k_codes, k_scale, v_codes, v_scale,
                                     pos, window)


def _check(t: torch.Tensor, name: str, dtype: torch.dtype,
           shape: tuple, device: torch.device) -> None:
    if t.device != device or t.dtype != dtype or not t.is_contiguous() \
            or tuple(t.shape) != shape:
        raise ValueError(f"{name}: need a contiguous {dtype} tensor of "
                         f"shape {shape} on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def int8_cache_attention_cuda(q: torch.Tensor, k_codes: torch.Tensor,
                              k_scale: torch.Tensor, v_codes: torch.Tensor,
                              v_scale: torch.Tensor, pos: torch.Tensor,
                              window: Optional[int] = None) -> torch.Tensor:
    """Launch the CUDA kernel: ``(R, G, Dh)`` queries -> ``(R, G, Dh)`` f32.

    ``pos`` is read on the card (no host sync).  Raises ``ValueError`` on
    what the kernel does not take (``Dh > 256``, a window below 1, wrong
    types or shapes) and ``RuntimeError`` if the launch fails.
    """
    dev = q.device
    if dev.type != "cuda" or q.dim() != 3:
        raise ValueError("int8_cache_attention_cuda takes (R, G, Dh) CUDA "
                         "queries")
    r, g, dh = q.shape
    t = k_codes.shape[1] if k_codes.dim() == 3 else 0
    if r < 1 or g < 1 or t < 1 or not 1 <= dh <= MAX_DH:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, cache "
                         f"{tuple(k_codes.shape)} (Dh <= {MAX_DH})")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    _check(q, "q", torch.float32, (r, g, dh), dev)
    _check(k_codes, "k_codes", torch.int8, (r, t, dh), dev)
    _check(v_codes, "v_codes", torch.int8, (r, t, dh), dev)
    _check(k_scale, "k_scale", torch.float32, (r, t, 1), dev)
    _check(v_scale, "v_scale", torch.float32, (r, t, 1), dev)
    _check(pos, "pos", torch.int32, (r,), dev)
    lib = _lib()
    out = torch.empty((r, g, dh), dtype=torch.float32, device=dev)
    with build.on_device(dev) as stream:
        err = lib.repro_int8_cache_attention(
            q.data_ptr(), k_codes.data_ptr(), k_scale.data_ptr(),
            v_codes.data_ptr(), v_scale.data_ptr(), pos.data_ptr(),
            out.data_ptr(), r, g, t, dh, 0 if window is None else window,
            dh ** -0.5, stream)
    if err:
        raise RuntimeError(f"int8_cache_attention launch failed: "
                           f"cudaError {err}")
    launches.add()
    return out
