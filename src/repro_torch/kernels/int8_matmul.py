"""Kernel B1: W8A8 / W4A8 integer GEMM with the affine dequant epilogue.

Replaces ``repro/kernels/int8_matmul.py: int8_matmul_pallas`` (Pallas
kernel ``_int8_matmul_kernel``).  The CUDA source is
``csrc/int8_matmul.cu``; its header note says what bounds it on the H100
(the bytes at the serving shapes, and in practice latency) and how the
design answers: ``wgmma`` on int8 tensor cores fed through an mbarrier
ring of shared-memory stages, N tiles narrow enough to give every SM a
block, and long K split over a thread block cluster whose partials are
added through distributed shared memory in the same launch.

``int8_matmul_cuda`` launches the kernel on the current stream and counts
the launch in ``launches``.  ``int8_matmul_plain`` is the same function in
plain PyTorch (``ref.int8_matmul_ref`` after unpacking int4 codes): the
CPU path, and what the kernel is held against bitwise on the card.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import affine
from repro_torch.kernels import build, ref

launches = build.LaunchCounter("int8_matmul")
_VP, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("int8_matmul")
    fn = lib.repro_int8_matmul
    fn.argtypes = [_VP] * 7 + [_I] * 4 + [_VP]
    fn.restype = _I
    lib.repro_int8_matmul_plan.argtypes = [_I, _I, _I, _VP]
    lib.repro_int8_matmul_plan.restype = None
    return lib


def plan(m: int, k: int, n: int) -> dict:
    """The kernel's tile plan for an ``(m, k, n)`` product: the N tile,
    the cluster's K split and the blocks launched (built on first use)."""
    out = (ctypes.c_int * 3)()
    _lib().repro_int8_matmul_plan(m, k, n, ctypes.addressof(out))
    return dict(bn=out[0], k_split=out[1], blocks=out[2])


def int8_matmul_plain(x_q: torch.Tensor, w_q: torch.Tensor,
                      x_scale: torch.Tensor, x_zero: torch.Tensor,
                      w_scale: torch.Tensor, w_zero: torch.Tensor, *,
                      w_bits: int = 8) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device."""
    if w_bits <= 4:
        w_q = affine.unpack_int4(w_q, x_q.shape[-1])
    return ref.int8_matmul_ref(x_q, w_q, x_scale, w_scale, x_zero, w_zero)


def _check(t: torch.Tensor, name: str, dtype: torch.dtype,
           device: torch.device, numel: int = -1) -> None:
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous {dtype} tensor on "
                         f"{device}, got {t.dtype} on {t.device}")
    if numel >= 0 and t.numel() != numel:
        raise ValueError(f"{name}: need {numel} elements, got {t.numel()}")


def int8_matmul_cuda(x_q: torch.Tensor, w_q: torch.Tensor,
                     x_scale: torch.Tensor, x_zero: torch.Tensor,
                     w_scale: torch.Tensor, w_zero: torch.Tensor, *,
                     w_bits: int = 8) -> torch.Tensor:
    """Launch the CUDA kernel: ``(M, K) int8 x (K, N) int8 -> (M, N) f32``.

    ``w_bits <= 4``: ``w_q`` is ``(ceil(K/2), N)`` with two int4 codes per
    byte.  Scalars ``x_scale``/``x_zero`` are one-element f32 tensors on
    the card (read there, no host sync); ``w_scale``/``w_zero`` are
    ``(N,)`` f32.  Raises ``ValueError`` on what the kernel does not take
    and ``RuntimeError`` if the launch fails.
    """
    dev = x_q.device
    if dev.type != "cuda" or x_q.dim() != 2 or w_q.dim() != 2:
        raise ValueError("int8_matmul_cuda takes 2-D CUDA tensors")
    m, k = x_q.shape
    n = w_q.shape[1]
    rows = (k + 1) // 2 if w_bits <= 4 else k
    if m < 1 or k < 1 or n < 1 or w_q.shape[0] != rows:
        raise ValueError(f"bad shapes x {tuple(x_q.shape)}, w "
                         f"{tuple(w_q.shape)} for w_bits={w_bits}")
    _check(x_q, "x_q", torch.int8, dev)
    _check(w_q, "w_q", torch.int8, dev)
    _check(x_scale, "x_scale", torch.float32, dev, 1)
    _check(x_zero, "x_zero", torch.float32, dev, 1)
    _check(w_scale, "w_scale", torch.float32, dev, n)
    _check(w_zero, "w_zero", torch.float32, dev, n)
    lib = _lib()
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    with build.on_device(dev) as stream:
        err = lib.repro_int8_matmul(
            x_q.data_ptr(), w_q.data_ptr(), x_scale.data_ptr(),
            x_zero.data_ptr(), w_scale.data_ptr(), w_zero.data_ptr(),
            out.data_ptr(), m, k, n, 4 if w_bits <= 4 else 8, stream)
    if err:
        raise RuntimeError(f"int8_matmul launch failed: cudaError {err}")
    launches.add()
    return out
