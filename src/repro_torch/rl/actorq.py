"""ActorQ: the packed int8/int4 actor (MLP path) of the port.

Counterpart of ``repro/rl/actorq.py`` (lines 85-157, 164-205, 259-302,
325-342, 489-554).  fp32 policy params are packed once per push into an
int cache (``pack_actor_params``); the actor forward then runs every dense
layer through the W8A8 / W4A8 integer GEMM (``kernels.ops.int8_matmul``,
kernel B1 on the card) with dynamic per-tensor activation quantization,
or -- once ``calibrate_actor_cache`` has attached static activation params
-- the whole MLP in one launch (``kernels.ops.fused_qmlp``, kernel B2).

The calibrated path is the dynamic path on the calibration batch, bit for
bit: the static params are exactly those the dynamic quantizer derives at
each layer, and the fused epilogue repeats the per-layer float op order.

Conv and sequence caches are not ported yet: they raise
``NotImplementedError`` naming the ROADMAP item that brings them.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.core import affine, ptq
from repro_torch.core.ptq import PackedTensor
from repro_torch.core.qconfig import QuantConfig
from repro_torch.kernels import ops
from repro_torch.kernels.fused_qmlp import QMLPLayer

QuantizedParams = Any

ACTOR_BACKENDS = ("fp32", "int8", "int4")
QUANTIZED_BACKENDS = ("int8", "int4")
_BACKEND_BITS = {"int8": 8, "int4": 4}

# key of the static activation params a calibrated cache carries
ACT_QUANT = "act_quant"


def validate_actor_backend(actor_backend: str) -> str:
    """Return ``actor_backend`` if it is one of ``ACTOR_BACKENDS``, else
    raise ``ValueError``."""
    if actor_backend not in ACTOR_BACKENDS:
        raise ValueError(f"actor_backend must be one of {ACTOR_BACKENDS}, "
                         f"got {actor_backend!r}")
    return actor_backend


def is_quantized(actor_backend: str) -> bool:
    """True for the integer-inference backends (int8/int4)."""
    return validate_actor_backend(actor_backend) in QUANTIZED_BACKENDS


def backend_bits(actor_backend: str) -> int:
    """Weight bit-width of a quantized actor backend (int8 -> 8, int4 -> 4)."""
    validate_actor_backend(actor_backend)
    if actor_backend not in _BACKEND_BITS:
        raise ValueError(f"actor_backend {actor_backend!r} is not a "
                         f"quantized backend {QUANTIZED_BACKENDS}")
    return _BACKEND_BITS[actor_backend]


def _check_mlp(qparams: QuantizedParams) -> None:
    names = set(qparams)
    if "embed" in names:
        raise NotImplementedError(
            "sequence-policy actors are not ported yet (ROADMAP queue A, "
            "item 12)")
    if any(n.startswith("conv") for n in names):
        raise NotImplementedError(
            "int8 conv actors are not ported yet (ROADMAP queue A, item 6)")


def pack_actor_params(params: Any, bits: int = 8) -> QuantizedParams:
    """Pack an fp32 MLP param tree into the int-code deployment cache.

    ``bits <= 4`` stores two codes per byte along K (W4A8, half the
    cache); activations always quantize to 8 bits at run time.
    """
    if not 1 <= bits <= 8:
        raise ValueError(f"int actor cache needs 1 <= bits <= 8, "
                         f"got {bits}")
    _check_mlp(params)
    return ptq.ptq_pack(params, QuantConfig.ptq_int(bits))


def packed_nbytes(qparams: QuantizedParams) -> int:
    """Parameter-memory footprint of the packed actor."""
    return ptq.tree_nbytes(qparams)


def calib_slice(obs: torch.Tensor, calib_batch: int) -> torch.Tensor:
    """Leading-axis slice of an observation batch for calibration."""
    return obs[:max(1, min(calib_batch, obs.shape[0]))]


def make_actor_cache(params: Any, actor_backend: str, *,
                     calib_obs: Optional[torch.Tensor] = None
                     ) -> QuantizedParams:
    """Pack (and, with ``calib_obs``, calibrate) one actor cache."""
    qparams = pack_actor_params(params, backend_bits(actor_backend))
    if calib_obs is not None:
        qparams = calibrate_actor_cache(qparams, calib_obs)
    return qparams


def _out_width(w: PackedTensor) -> int:
    return w.orig_shape[-1] if w.orig_shape is not None else w.codes.shape[-1]


def int8_dense(layer: Dict[str, Any], x: torch.Tensor, *,
               act: Optional[Callable] = None) -> torch.Tensor:
    """One dense layer through the W{8,4}A8 integer GEMM.

    ``layer`` is ``{"w": PackedTensor, "b": f32}``; ``x`` is f32 with any
    leading batch dims.  The activation is quantized per tensor to 8 bits
    from the live batch's range, the product accumulates in int32, and
    the affine dequant is the kernel's epilogue; the bias is added after.
    """
    w: PackedTensor = layer["w"]
    lead = x.shape[:-1]
    xq, xp = affine.quantize_to_int(
        x.reshape(-1, x.shape[-1]).contiguous(), 8)
    y = ops.int8_matmul(xq, w.codes, xp.delta, xp.zero_point, w.col_scale,
                        w.col_zero, w_bits=w.bits if w.bits <= 4 else 8)
    y = y + layer["b"]
    if act is not None:
        y = act(y)
    return y.reshape(lead + (_out_width(w),))


def _mlp_layer_names(n_hidden: int):
    return [f"fc{i}" for i in range(n_hidden)] + ["out"]


def _fused_layers(qparams: QuantizedParams, n_hidden: int):
    """``(QMLPLayer, ...)`` for the fused kernel from a calibrated cache."""
    act = qparams[ACT_QUANT]
    layers = []
    for i, name in enumerate(_mlp_layer_names(n_hidden)):
        w: PackedTensor = qparams[name]["w"]
        k = w.orig_shape[0] if w.orig_shape is not None else w.codes.shape[0]
        x_delta, x_zero = act[i]
        layers.append(QMLPLayer(
            codes=w.codes, col_scale=w.col_scale, col_zero=w.col_zero,
            bias=qparams[name]["b"], x_delta=x_delta, x_zero=x_zero,
            bits=w.bits, k=k))
    return tuple(layers)


def quantized_mlp_apply(qparams: QuantizedParams, x: torch.Tensor,
                        n_hidden: int) -> torch.Tensor:
    """MLP head outputs from a packed cache.

    A calibrated cache (one carrying ``ACT_QUANT``) runs the whole
    forward in one fused launch; an uncalibrated one runs the per-layer
    GEMM with dynamic activation quantization.
    """
    if ACT_QUANT in qparams:
        return ops.fused_qmlp(x, _fused_layers(qparams, n_hidden))
    for i in range(n_hidden):
        x = int8_dense(qparams[f"fc{i}"], x, act=torch.relu)
    return int8_dense(qparams["out"], x)


def quantized_apply(qparams: QuantizedParams, x: torch.Tensor
                    ) -> torch.Tensor:
    """Head outputs of the packed actor (MLP caches)."""
    _check_mlp(qparams)
    n_hidden = sum(1 for n in qparams if n.startswith("fc"))
    return quantized_mlp_apply(qparams, x, n_hidden)


def calibrate_actor_cache(qparams: QuantizedParams, obs: torch.Tensor
                          ) -> QuantizedParams:
    """Attach static activation params to a packed MLP cache.

    Runs the per-layer dynamic path once over ``obs`` and records, per
    dense layer, the affine params the dynamic quantizer derives for that
    layer's input.  ``quantized_apply`` on the returned cache then takes
    the single-launch fused kernel.
    """
    _check_mlp(qparams)
    n_hidden = sum(1 for n in qparams if n.startswith("fc"))
    act = []
    x = obs.reshape(-1, obs.shape[-1]).to(torch.float32)
    for i, name in enumerate(_mlp_layer_names(n_hidden)):
        p = affine.calibration_params(x, 8)
        act.append((p.delta, p.zero_point))
        if i < n_hidden:
            x = int8_dense(qparams[name], x, act=torch.relu)
    return {**qparams, ACT_QUANT: tuple(act)}


def make_act_fn(env_spec) -> Callable:
    """Deterministic deployment policy ``act(qparams, obs)``.

    Discrete envs: argmax over the first ``n_actions`` head outputs
    (int32).  Continuous envs: ``tanh(mu) * action_scale`` (f32).
    """
    if env_spec.continuous:
        def act(qparams, obs):
            """Continuous head: tanh * action_scale, f32 actions."""
            return torch.tanh(quantized_apply(qparams, obs)) \
                * env_spec.action_scale
    else:
        n_act = env_spec.n_actions

        def act(qparams, obs):
            """Discrete head: argmax over n_actions outputs, int32."""
            out = quantized_apply(qparams, obs)
            return torch.argmax(out[..., :n_act], dim=-1).to(torch.int32)
    return act
