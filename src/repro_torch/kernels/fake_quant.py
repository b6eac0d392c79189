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

The QAT site kernel does a whole quantization-aware-training site in one
launch (``core.fake_quant.QATContext``): ``activation_site_cuda`` (batch
range, observer update, fake quantization and the delay's gates) and
``weight_site_cuda`` (own range, fake quantization, the gate).  Their
plain versions, ``activation_site_plain`` and ``weight_site_plain``, are
the composition the context ran before (``observe_plain`` +
``fake_quant_plain`` + ``torch.where``).  A site of at most 4,096
elements is one launch; a larger one is two (a range pass and a quantize
pass), and ``launches`` counts both.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from typing import Tuple

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
    site = lib.repro_fake_quant_site
    site.argtypes = ([_VP, _VP, ctypes.c_longlong, _I, _I] + [_VP] * 7
                     + [_I, ctypes.c_longlong, ctypes.c_float,
                        ctypes.c_float, _VP, _I, _VP])
    site.restype = _I
    lib.repro_fake_quant_site_scratch.argtypes = [ctypes.c_longlong]
    lib.repro_fake_quant_site_scratch.restype = ctypes.c_longlong
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
    with build.on_device(dev) as stream:
        err = lib.repro_fake_quant(
            x.data_ptr(), vmin.data_ptr(), vmax.data_ptr(), out.data_ptr(),
            n, bits, vec, stream)
    if err:
        raise RuntimeError(f"fake_quant launch failed: cudaError {err}")
    launches.add()
    return out


# ---- the QAT site --------------------------------------------------------

_WEIGHT, _ACTIVATION = 0, 1


def observe_plain(vmin: torch.Tensor, vmax: torch.Tensor,
                  initialized: torch.Tensor, x: torch.Tensor,
                  ema_decay: float, monitoring: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The observer update of ``core.fake_quant.observe`` in plain
    PyTorch: the batch range extended to 0, an EMA of it once
    initialized, kept while ``monitoring``, frozen after."""
    lo, hi = torch.aminmax(x.detach())
    bmin = torch.clamp(lo, max=0.0).to(torch.float32)
    bmax = torch.clamp(hi, min=0.0).to(torch.float32)
    d = ema_decay
    new_min = torch.where(initialized, d * vmin + (1 - d) * bmin, bmin)
    new_max = torch.where(initialized, d * vmax + (1 - d) * bmax, bmax)
    return (torch.where(monitoring, new_min, vmin),
            torch.where(monitoring, new_max, vmax),
            initialized | monitoring)


def activation_site_plain(x: torch.Tensor, vmin: torch.Tensor,
                          vmax: torch.Tensor, initialized: torch.Tensor,
                          step: torch.Tensor, quant_delay: int,
                          ema_decay: float, bits: int
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor, torch.Tensor]:
    """Plain version of the activation site: ``(out, vmin', vmax',
    initialized')``, the composition ``QATContext.activation`` ran."""
    monitoring = step < quant_delay
    enabled = step >= quant_delay
    nmin, nmax, ninit = observe_plain(vmin, vmax, initialized, x,
                                      ema_decay, monitoring)
    fq = fake_quant_plain(x, nmin, nmax, bits)
    return torch.where(enabled & ninit, fq, x), nmin, nmax, ninit


def weight_site_plain(w: torch.Tensor, step: torch.Tensor,
                      quant_delay: int, bits: int) -> torch.Tensor:
    """Plain version of the weight site: ``w`` fake-quantized over its own
    range from ``quant_delay`` on, as ``QATContext.weight`` did."""
    return torch.where(step >= quant_delay, ref.fake_quant_ref(w, bits), w)


def _site_launch(x: torch.Tensor, kind: int, bits: int, step: torch.Tensor,
                 quant_delay: int, state=(), ema_decay: float = 0.0):
    dev = x.device
    if dev.type != "cuda":
        raise ValueError("the site kernel takes a CUDA tensor")
    if not 1 <= bits <= MAX_BITS:
        raise ValueError(f"bits must be in [1, {MAX_BITS}], got {bits}")
    if x.dtype != torch.float32 or not x.is_contiguous() or x.numel() < 1:
        raise ValueError(f"x: need a non-empty contiguous float32 tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")
    if step.numel() != 1 or step.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"step: need one int32 or int64 element, got "
                         f"{step.dtype} {tuple(step.shape)}")
    step = step.to(dev)
    if kind == _ACTIVATION:
        vmin, vmax, init = (t.to(dev) for t in state)
        for name, t, dt in (("vmin", vmin, torch.float32),
                            ("vmax", vmax, torch.float32),
                            ("initialized", init, torch.bool)):
            if t.dtype != dt or t.numel() != 1:
                raise ValueError(f"{name}: need one {dt} element, got "
                                 f"{t.dtype} {tuple(t.shape)}")
        new = (torch.empty((), dtype=torch.float32, device=dev),
               torch.empty((), dtype=torch.float32, device=dev),
               torch.empty((), dtype=torch.bool, device=dev))
        ptrs = [t.data_ptr() for t in (vmin, vmax, init) + new]
    else:
        new, ptrs = (), [None] * 6
    out = torch.empty_like(x)
    n = x.numel()
    lib = _lib()
    n_scratch = lib.repro_fake_quant_site_scratch(n)
    scratch = (torch.empty(n_scratch, dtype=torch.float32, device=dev)
               if n_scratch else None)
    vec = int(x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    with build.on_device(dev) as stream:
        err = lib.repro_fake_quant_site(
            x.data_ptr(), out.data_ptr(), n, bits, kind, *ptrs,
            step.data_ptr(), int(step.dtype == torch.int64), quant_delay,
            ema_decay, 1.0 - ema_decay,
            None if scratch is None else scratch.data_ptr(), vec, stream)
    if err:
        raise RuntimeError(f"fake_quant site launch failed: cudaError {err}")
    launches.add(2 if n_scratch else 1)   # two passes above one block
    return (out,) + new


def activation_site_cuda(x: torch.Tensor, vmin: torch.Tensor,
                         vmax: torch.Tensor, initialized: torch.Tensor,
                         step: torch.Tensor, quant_delay: int,
                         ema_decay: float, bits: int
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor, torch.Tensor]:
    """Launch the site kernel for an activation site: ``(out, vmin',
    vmax', initialized')``, the new state in fresh 0-d tensors.

    ``x`` is a contiguous f32 CUDA tensor; the old state and ``step`` (int32
    or int64) are 0-d tensors read on the card.  ``ema_decay`` and ``1 -
    ema_decay`` reach the kernel rounded to float32, as torch rounds a
    Python scalar.  Raises ``ValueError`` on what the kernel does not take
    and ``RuntimeError`` if the launch fails.
    """
    return _site_launch(x, _ACTIVATION, bits, step, quant_delay,
                        (vmin, vmax, initialized), ema_decay)


def weight_site_cuda(w: torch.Tensor, step: torch.Tensor, quant_delay: int,
                     bits: int) -> torch.Tensor:
    """Launch the site kernel for a weight site: ``w`` fake-quantized over
    its own range where ``step >= quant_delay``, else ``w``."""
    return _site_launch(w, _WEIGHT, bits, step, quant_delay)[0]
