"""Kernel B2: the whole quantized-MLP actor forward in one launch.

Replaces ``repro/kernels/fused_qmlp.py: fused_qmlp_pallas`` (Pallas kernel
``_fused_qmlp_kernel``, per-layer ``_layer_forward``).  The CUDA source is
``csrc/fused_qmlp.cu``; its header note says what bounds it on the H100
(latency: the launch, the first loads and the chain of layers, at the
main-path shapes) and how the design answers (every layer's codes copied
into shared memory at the start with cp.async, one group a layer, and
each transposed K-major in shared memory just before its layer; int8
tensor-core tiles with every warp at every layer; activations int8 in
shared memory).  ``plan`` gives the launch's shape as
plain arithmetic: what is staged (Policy II whole; Policy III's wide
layers stay in global memory and stream through L2) and the shared
memory the block takes.

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
RED_BYTES = 8 * 32 * 7 * 4      # csrc/fused_qmlp.cu: split-K partials
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
    fn.argtypes = [_VP, _I, _I, _I] + [_VP] * 10 + [_I] * 4 + [_VP, _VP]
    fn.restype = _I
    return lib


def _code_bytes(layer: QMLPLayer) -> int:
    return ((layer.k + 1) // 2 if layer.bits <= 4 else layer.k) * layer.n


def _kmajor_bytes(layer: QMLPLayer) -> int:
    """A layer's codes K-major (csrc/fused_qmlp.cu: KMajor): N rounded up
    to 8 rows of K rounded up to 32 codes plus 16 bytes."""
    return -(-layer.n // 8) * 8 * (-(-layer.k // 32) * 32 + 16)


def plan(m: int, k0: int, layers: Sequence[QMLPLayer]) -> dict:
    """The kernel's launch shape for ``m`` rows of ``k0`` input codes.

    A block takes ``ROWS`` rows.  Shared memory holds two activation
    buffers (row stride the widest activation rounded up to 32, plus 16
    bytes so that the fragment loads hit distinct banks), the split-K
    partials, one K-major buffer as large as the widest staged layer's
    codes K-major (int4 unpacked), then a copy of the codes of every layer
    that still fits under ``SMEM_LIMIT`` with that buffer, in layer order,
    each at a 16-byte boundary.  ``staged`` gives each copy's byte offset,
    or -1 where the kernel reads the codes from global memory instead.
    """
    widest = max([k0] + [layer.n for layer in layers[:-1]])
    stride = -(-widest // 32) * 32 + 16
    red = 2 * ROWS * stride
    kmajor = red + RED_BYTES
    buf, copies, chosen = 0, 0, []
    for layer in layers:
        b = max(buf, -(-_kmajor_bytes(layer) // 16) * 16)
        c = copies + -(-_code_bytes(layer) // 16) * 16
        if kmajor + b + c <= SMEM_LIMIT:
            buf, copies = b, c
            chosen.append(True)
        else:
            chosen.append(False)
    staged, at = [], kmajor + buf
    for layer, keep in zip(layers, chosen):
        staged.append(at if keep else -1)
        at += -(-_code_bytes(layer) // 16) * 16 if keep else 0
    return dict(rows=ROWS, blocks=-(-m // ROWS), cluster=1, stride=stride,
                red=red, kmajor=kmajor, staged=staged, smem=at)


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
    shape = plan(m, k0, layers)
    if shape["red"] + RED_BYTES > SMEM_LIMIT:
        raise ValueError(f"activations {shape['stride']} wide do not fit "
                         f"one block's shared memory")
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
               ints([4 if la.bits <= 4 else 8 for la in layers]),
               ints(shape["staged"])]
    with build.on_device(dev) as stream:
        err = lib.repro_fused_qmlp(
            x_q.data_ptr(), m, k0, n_l,
            *[ctypes.addressof(a) for a in arrays],
            shape["stride"], shape["red"], shape["kmajor"], shape["smem"],
            out.data_ptr(), stream)
    if err:
        raise RuntimeError(f"fused_qmlp launch failed: cudaError {err}")
    launches.add()
    return out
