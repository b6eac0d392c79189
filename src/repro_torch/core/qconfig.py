"""Quantization configuration (the subset ``ptq.ptq_pack`` needs).

Counterpart of ``repro/core/qconfig.py``: the ``QuantMode`` vocabulary of
the paper and ``QuantConfig.ptq_int(bits)``, the post-training integer
quantization the packed actor cache is built with.
"""
from __future__ import annotations

import dataclasses
import enum


class QuantMode(enum.Enum):
    """Quantization regime (paper vocabulary; the port has PTQ_INT so far)."""

    NONE = "none"
    PTQ_INT = "ptq_int"


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Which quantizer is active and at how many bits."""

    mode: QuantMode = QuantMode.NONE
    bits: int = 8

    @staticmethod
    def none() -> "QuantConfig":
        """No quantization (the fp32 learner and actor)."""
        return QuantConfig()

    @staticmethod
    def ptq_int(bits: int = 8) -> "QuantConfig":
        """Post-training uniform affine quantization to ``bits`` bits."""
        return QuantConfig(mode=QuantMode.PTQ_INT, bits=bits)
