"""Kernel B2: the whole quantized-MLP actor forward in one launch.

Replaces ``repro/kernels/fused_qmlp.py: fused_qmlp_pallas`` (Pallas kernel
``_fused_qmlp_kernel``, per-layer ``_layer_forward``).  The CUDA source is
``csrc/fused_qmlp.cu``; its header note says what bounds it on the H100
(launch latency at Policy II, int8 operations at Policy III) and how the
design answers (one block per 16 rows walks every layer; activations stay
int8 in shared memory; weights stream from global memory through L2,
since 227 KB of shared memory cannot hold Policy III's 2.7 MB).

``fused_qmlp_cuda`` launches the kernel and counts the launch in
``launches``; ``fused_qmlp_plain`` (``ref.fused_qmlp_ref``) is the plain
PyTorch version it is held against bitwise, and the CPU path.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Sequence

import torch

from repro_torch.kernels import build, ref

launches = build.LaunchCounter("fused_qmlp")
MAX_LAYERS = 8                  # csrc/fused_qmlp.cu: MAX_LAYERS
ROWS = 16                       # csrc/fused_qmlp.cu: rows per block
SMEM_LIMIT = 232448             # H100: dynamic shared memory per block
_VP, _I = ctypes.c_void_p, ctypes.c_int


@dataclasses.dataclass(frozen=True, eq=False)
class QMLPLayer:
    """One fused-MLP layer: kernel-layout weights + static input quant.

    ``codes`` is ``(K, N)`` int8, or ``(ceil(K/2), N)`` packed pairs when
    ``bits <= 4``; ``col_scale``/``col_zero``/``bias`` are ``(N,)`` f32;
    ``x_delta``/``x_zero`` are the 0-d f32 static params (signed-storage
    form) of this layer's input: layer 0's pair quantizes the observation,
    layer ``i+1``'s pair is the requant target of hidden layer ``i``.
    ``k`` is the true contraction length.
    """

    codes: torch.Tensor
    col_scale: torch.Tensor
    col_zero: torch.Tensor
    bias: torch.Tensor
    x_delta: torch.Tensor
    x_zero: torch.Tensor
    bits: int = 8
    k: int = 0

    @property
    def n(self) -> int:
        """Output width."""
        return self.codes.shape[-1]


def fused_qmlp_plain(x_q: torch.Tensor, layers: Sequence[QMLPLayer]
                     ) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device."""
    return ref.fused_qmlp_ref(x_q, layers)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("fused_qmlp")
    fn = lib.repro_fused_qmlp
    fn.argtypes = [_VP, _I, _I, _I] + [_VP] * 9 + [_I, _VP, _VP]
    fn.restype = _I
    return lib


def _smem_stride(k0: int, layers: Sequence[QMLPLayer]) -> int:
    """Shared-memory row stride: the widest activation, rounded up to 16."""
    widest = max([k0] + [layer.n for layer in layers[:-1]])
    return -(-widest // 16) * 16


def fused_qmlp_cuda(x_q: torch.Tensor, layers: Sequence[QMLPLayer]
                    ) -> torch.Tensor:
    """Launch the CUDA kernel: ``(M, K0) int8 -> (M, N_out) f32``.

    Raises ``ValueError`` on what the kernel does not take (layer chain
    widths that do not meet, too many layers, activations wider than the
    block's shared memory) and ``RuntimeError`` if the launch fails.
    """
    dev = x_q.device
    if dev.type != "cuda" or x_q.dim() != 2 or x_q.dtype != torch.int8 \
            or not x_q.is_contiguous():
        raise ValueError("fused_qmlp_cuda takes contiguous 2-D int8 CUDA "
                         "codes")
    m, k0 = x_q.shape
    if m < 1:
        raise ValueError("fused_qmlp_cuda needs at least one row")
    if not 1 <= len(layers) <= MAX_LAYERS:
        raise ValueError(f"fused_qmlp takes 1..{MAX_LAYERS} layers, got "
                         f"{len(layers)}")
    k_in = k0
    for i, layer in enumerate(layers):
        rows = (layer.k + 1) // 2 if layer.bits <= 4 else layer.k
        if layer.k != k_in or layer.codes.shape[0] != rows:
            raise ValueError(f"layer {i} expects K={layer.k} "
                             f"(codes {tuple(layer.codes.shape)}), its "
                             f"input has {k_in}")
        for name in ("codes", "col_scale", "col_zero", "bias", "x_delta",
                     "x_zero"):
            t = getattr(layer, name)
            want = torch.int8 if name == "codes" else torch.float32
            if t.device != dev or t.dtype != want or not t.is_contiguous():
                raise ValueError(f"layer {i} {name}: need contiguous {want} "
                                 f"on {dev}, got {t.dtype} on {t.device}")
        k_in = layer.n
    stride = _smem_stride(k0, layers)
    if 2 * ROWS * stride + 4 * ROWS > SMEM_LIMIT:
        raise ValueError(f"activations {stride} wide do not fit one block's "
                         f"shared memory")
    n_out = layers[-1].n
    lib = _lib()
    out = torch.empty((m, n_out), dtype=torch.float32, device=dev)
    n_l = len(layers)

    def ptrs(name):
        return (_VP * n_l)(*[getattr(la, name).data_ptr() for la in layers])

    def ints(vals):
        return (_I * n_l)(*vals)

    arrays = [ptrs(f) for f in ("codes", "col_scale", "col_zero", "bias",
                                "x_delta", "x_zero")]
    arrays += [ints([la.k for la in layers]), ints([la.n for la in layers]),
               ints([4 if la.bits <= 4 else 8 for la in layers])]
    with build.on_device(dev) as stream:
        err = lib.repro_fused_qmlp(
            x_q.data_ptr(), m, k0, n_l,
            *[ctypes.addressof(a) for a in arrays],
            stride, out.data_ptr(), stream)
    if err:
        raise RuntimeError(f"fused_qmlp launch failed: cudaError {err}")
    launches.add()
    return out
