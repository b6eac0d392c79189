"""Kernel B5: fused affine quantize-dequantize with a scalar range.

Replaces ``repro/kernels/fake_quant.py: fake_quant_pallas`` (Pallas kernel
``_fake_quant_kernel``).  The CUDA source is ``csrc/fake_quant.cu``; its
header note says what bounds it on the H100 (the bytes: one read and one
write per element) and how the design answers (a flat grid-stride loop
over 16-byte float4s, the range read through device pointers).

``fake_quant_cuda`` launches the kernel on the current stream and counts
the launch in ``launches``.  ``fake_quant_plain`` is the same function in
plain PyTorch (``ref.fake_quant_with_range_ref``): the CPU path, and what
the kernel is held against bitwise on the card.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

launches = build.LaunchCounter("fake_quant")
MAX_BITS = 16                   # csrc/fake_quant.cu: bits in [1, 16]
_VP, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("fake_quant")
    fn = lib.repro_fake_quant
    fn.argtypes = [_VP] * 4 + [ctypes.c_longlong, _I, _I, _VP]
    fn.restype = _I
    return lib


def fake_quant_plain(x: torch.Tensor, vmin: torch.Tensor, vmax: torch.Tensor,
                     bits: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device."""
    return ref.fake_quant_with_range_ref(x, vmin, vmax, bits)


def fake_quant_cuda(x: torch.Tensor, vmin: torch.Tensor, vmax: torch.Tensor,
                    bits: int) -> torch.Tensor:
    """Launch the CUDA kernel: ``x`` quantize-dequantized, same shape.

    ``x`` is a contiguous f32 CUDA tensor of any shape; ``vmin``/``vmax``
    are one-element f32 tensors on the same card (read there, no host
    sync).  Raises ``ValueError`` on what the kernel does not take and
    ``RuntimeError`` if the launch fails.
    """
    dev = x.device
    if dev.type != "cuda":
        raise ValueError("fake_quant_cuda takes a CUDA tensor")
    if not 1 <= bits <= MAX_BITS:
        raise ValueError(f"bits must be in [1, {MAX_BITS}], got {bits}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"x: need a contiguous float32 tensor, got "
                         f"{x.dtype}")
    for name, t in (("vmin", vmin), ("vmax", vmax)):
        if t.device != dev or t.dtype != torch.float32 or t.numel() != 1:
            raise ValueError(f"{name}: need one float32 element on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    out = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return out
    vec = int(x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.repro_fake_quant(
            x.data_ptr(), vmin.data_ptr(), vmax.data_ptr(), out.data_ptr(),
            n, bits, vec, stream)
    if err:
        raise RuntimeError(f"fake_quant launch failed: cudaError {err}")
    launches.add()
    return out
