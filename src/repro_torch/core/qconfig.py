"""Quantization configuration shared across the port.

Counterpart of ``repro/core/qconfig.py``.  The vocabulary follows the
paper (QuaRL):

* ``none``       -- full precision;
* ``ptq_fp16``   -- post-training quantization to IEEE fp16 (Sec. 3.1);
* ``ptq_int<n>`` -- post-training uniform affine quantization to n bits;
* ``qat<n>``     -- quantization-aware training at n bits with the
  straight-through estimator and a quantization delay (Sec. 3.2).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class QuantMode(enum.Enum):
    """Quantization regime (the paper's vocabulary)."""

    NONE = "none"
    PTQ_FP16 = "ptq_fp16"
    PTQ_INT = "ptq_int"
    QAT = "qat"

    def __str__(self) -> str:
        return self.value


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Configuration of the paper's quantizers.

    ``bits`` is the integer width of PTQ_INT / QAT.  ``quant_delay`` is
    the number of training *updates* (TD updates for DQN, counted by the
    train state's ``step``) run in full precision while the min/max
    observers monitor ranges; after it the ranges freeze and fake
    quantization turns on.  ``ema_decay`` smooths the observers.
    ``quantize_activations``: QAT quantizes activations as well as
    weights; PTQ weights only.  ``per_axis_conv``: per-output-channel
    quantization of conv kernels.  ``quantize_router``: whether MoE
    router layers are quantized.  ``int8_kv_cache``: store the LM decode
    KV cache as int8 codes with per-token scales.
    """

    mode: QuantMode = QuantMode.NONE
    bits: int = 8
    quant_delay: int = 0
    ema_decay: float = 0.999
    quantize_activations: bool = True
    per_axis_conv: bool = True
    quantize_router: bool = False
    int8_kv_cache: bool = False

    @staticmethod
    def none() -> "QuantConfig":
        """No quantization."""
        return QuantConfig(mode=QuantMode.NONE)

    @staticmethod
    def ptq_fp16() -> "QuantConfig":
        """Post-training fp16 round trip of the weights."""
        return QuantConfig(mode=QuantMode.PTQ_FP16,
                           quantize_activations=False)

    @staticmethod
    def ptq_int(bits: int = 8) -> "QuantConfig":
        """Post-training uniform affine quantization to ``bits`` bits."""
        return QuantConfig(mode=QuantMode.PTQ_INT, bits=bits,
                           quantize_activations=False)

    @staticmethod
    def qat(bits: int = 8, quant_delay: int = 0,
            quantize_activations: bool = True) -> "QuantConfig":
        """Quantization-aware training at ``bits`` bits after
        ``quant_delay`` updates."""
        return QuantConfig(mode=QuantMode.QAT, bits=bits,
                           quant_delay=quant_delay,
                           quantize_activations=quantize_activations)

    @staticmethod
    def parse(spec: str) -> "QuantConfig":
        """Parse a CLI spec: none | ptq_fp16 | ptq_int8 | ptq_int4 | qat8 |
        qat4:delay=1000."""
        spec = spec.strip().lower()
        if spec in ("none", "fp32", "full"):
            return QuantConfig.none()
        if spec in ("ptq_fp16", "fp16"):
            return QuantConfig.ptq_fp16()
        if spec.startswith("ptq_int"):
            return QuantConfig.ptq_int(int(spec[len("ptq_int"):]))
        if spec.startswith("qat"):
            body = spec[len("qat"):]
            delay = 0
            if ":" in body:
                body, opts = body.split(":", 1)
                for kv in opts.split(","):
                    k, v = kv.split("=")
                    if k == "delay":
                        delay = int(v)
            return QuantConfig.qat(int(body), quant_delay=delay)
        raise ValueError(f"unknown quant spec: {spec!r}")

    @property
    def is_qat(self) -> bool:
        """True for quantization-aware training."""
        return self.mode == QuantMode.QAT

    @property
    def is_ptq(self) -> bool:
        """True for either post-training mode."""
        return self.mode in (QuantMode.PTQ_FP16, QuantMode.PTQ_INT)

    @property
    def enabled(self) -> bool:
        """True unless the mode is ``none``."""
        return self.mode != QuantMode.NONE

    def label(self) -> str:
        """Short name: fp32, ptq_fp16, ptq_int<n> or qat<n>."""
        if self.mode == QuantMode.NONE:
            return "fp32"
        if self.mode == QuantMode.PTQ_FP16:
            return "ptq_fp16"
        if self.mode == QuantMode.PTQ_INT:
            return f"ptq_int{self.bits}"
        return f"qat{self.bits}"


@dataclasses.dataclass(frozen=True)
class MixedPrecisionConfig:
    """Mixed/half-precision policy (paper Sec. 5), as data.

    Counterpart of ``repro/core/qconfig.py:129-157``.  ``compute_dtype``
    is the activations' and matmuls' type, ``param_dtype`` the master
    weights'; ``loss_scale`` / ``dynamic_loss_scale`` guard fp16
    gradients.  LM training casts by it (``core.mixed_precision.
    to_compute`` in ``launch.steps.make_train_step``); the LM inference
    path runs in float32, as the reference's serve launcher does.
    """

    compute_dtype: str = "float32"   # "bfloat16" | "float16" | "float32"
    param_dtype: str = "float32"
    loss_scale: Optional[float] = None
    dynamic_loss_scale: bool = False

    @property
    def enabled(self) -> bool:
        """True when compute and parameter types differ."""
        return self.compute_dtype != self.param_dtype

    @staticmethod
    def fp32() -> "MixedPrecisionConfig":
        """Everything in float32."""
        return MixedPrecisionConfig()

    @staticmethod
    def bf16() -> "MixedPrecisionConfig":
        """bfloat16 compute over float32 master weights."""
        return MixedPrecisionConfig(compute_dtype="bfloat16")

    @staticmethod
    def fp16() -> "MixedPrecisionConfig":
        """float16 compute with dynamic loss scaling."""
        return MixedPrecisionConfig(compute_dtype="float16",
                                    dynamic_loss_scale=True)
