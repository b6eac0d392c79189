"""Architecture and input-shape registry of the port.

Counterpart of ``repro/configs/base.py``.  Each ported architecture has a
module here exporting ``CONFIG`` (the published dimensions, source cited)
and ``REDUCED`` (the smoke-test variant of the same family), registered
under its ``--arch`` name: every LM config of the reference, dense
attention, MoE, recurrent (RG-LRU, xLSTM), the encoder-decoder
(whisper-tiny) and cross-attention (llama-3.2-vision-90b) ones, and
grok-1-314b with bfloat16 parameters.  ``remat`` turns on per-unit activation
checkpointing in training; ``sharding`` and ``scan_layers`` are kept as
inert data: the port runs on one card with no mesh, and loops over the
stacked layers.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.core.qconfig import MixedPrecisionConfig, QuantConfig

# Block kinds usable in a layer pattern.
ATTN = "attn"              # global self-attention
ATTN_LOCAL = "attn_local"  # sliding-window self-attention
MOE = "moe"                # attention + MoE ffn
MOE_LOCAL = "moe_local"    # sliding-window attention + MoE ffn
RGLRU = "rglru"            # RG-LRU recurrent block (griffin)
MLSTM = "mlstm"            # xLSTM matrix-memory block
SLSTM = "slstm"            # xLSTM scalar-memory block
CROSS = "cross"            # self-attn + cross-attn to modality embeddings


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One architecture: dimensions, block pattern and attention flavour.

    Field for field the reference's ``ArchConfig``.
    """

    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    source: str                      # citation for the exact dims
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None   # default d_model // n_heads
    pattern: Tuple[str, ...] = (ATTN,)   # repeating block-kind unit
    # MoE
    n_experts: int = 0
    moe_top_k: int = 2
    capacity_factor: float = 1.25
    # attention flavour
    window: Optional[int] = None         # sliding-window size for *_local
    softcap: Optional[float] = None      # gemma2 logit soft-cap
    final_softcap: Optional[float] = None
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    norm: str = "rms"                    # rms | layer
    activation: str = "silu"             # silu (SwiGLU) | gelu (GeGLU)
    # enc-dec / multimodal frontends (precomputed embeddings)
    encoder_layers: int = 0
    encoder_seq: int = 0
    cross_attn: bool = False
    # distribution (inert on one card)
    sharding: str = "tp"                 # tp | fsdp
    remat: bool = True
    scan_layers: bool = True
    # training
    quant: QuantConfig = QuantConfig.none()
    mp: MixedPrecisionConfig = MixedPrecisionConfig.bf16()
    optimizer_8bit: bool = False
    grad_accum: int = 1
    # decode
    long_context_window: Optional[int] = None
    supports_long_500k: bool = True

    @property
    def hd(self) -> int:
        """Head dimension."""
        return self.head_dim or self.d_model // self.n_heads

    @property
    def pattern_repeats(self) -> int:
        """Whole repeats of ``pattern`` (the stacked ``layers`` axis)."""
        return self.n_layers // len(self.pattern)

    @property
    def pattern_remainder(self) -> Tuple[str, ...]:
        """Block kinds left over after the whole repeats."""
        return tuple(self.pattern[: self.n_layers % len(self.pattern)])

    def n_params(self) -> int:
        """Analytic parameter count."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        hd, nh, nkv = self.hd, self.n_heads, self.n_kv_heads
        total = v * d * (1 if self.tie_embeddings else 2)
        kinds = (list(self.pattern) * self.pattern_repeats
                 + list(self.pattern_remainder))
        for kind in kinds:
            attn = d * nh * hd + 2 * d * nkv * hd + nh * hd * d
            if kind in (ATTN, ATTN_LOCAL):
                total += attn + 3 * d * f
            elif kind in (MOE, MOE_LOCAL):
                total += attn + self.n_experts * 3 * d * f + d * self.n_experts
            elif kind == RGLRU:
                total += 3 * d * (2 * d) + 2 * (2 * d)
            elif kind in (MLSTM, SLSTM):
                total += 8 * d * d
            elif kind == CROSS:
                total += 2 * attn + 3 * d * f
        total += self.encoder_layers * (4 * d * d + 3 * d * f)
        return total

    def n_active_params(self) -> int:
        """Active params per token (MoE: top-k of the experts)."""
        if self.n_experts == 0:
            return self.n_params()
        d, f = self.d_model, self.d_ff
        kinds = (list(self.pattern) * self.pattern_repeats
                 + list(self.pattern_remainder))
        n_moe = sum(1 for k in kinds if k in (MOE, MOE_LOCAL))
        return self.n_params() - n_moe * (
            self.n_experts - self.moe_top_k) * 3 * d * f


@dataclasses.dataclass(frozen=True)
class InputShape:
    """A named (sequence length, global batch, kind) workload shape."""

    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode

    @property
    def tokens(self) -> int:
        """Tokens per step."""
        return self.seq_len * self.global_batch


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchEntry:
    """A registered config and its reduced variant."""

    config: ArchConfig
    reduced: ArchConfig


_REGISTRY: Dict[str, ArchEntry] = {}

# the port's config modules: the LM configs it runs
_ARCH_MODULES = ["h2o_danube_1_8b", "gemma2_9b", "recurrentgemma_2b",
                 "xlstm_125m", "mixtral_8x7b", "codeqwen1_5_7b",
                 "stablelm_12b", "whisper_tiny", "llama_3_2_vision_90b",
                 "grok_1_314b"]


def register(config: ArchConfig, reduced: ArchConfig) -> ArchConfig:
    """Register ``config`` (and its reduced variant) under its name."""
    _REGISTRY[config.name] = ArchEntry(config, reduced)
    return config


def _entry(name: str) -> ArchEntry:
    _ensure_loaded()
    if name in _REGISTRY:
        return _REGISTRY[name]
    raise KeyError(f"unknown architecture {name!r}")


def get(name: str) -> ArchConfig:
    """The published config registered as ``name``."""
    return _entry(name).config


def get_reduced(name: str) -> ArchConfig:
    """The reduced (smoke-test) variant of ``name``."""
    return _entry(name).reduced


def names() -> Sequence[str]:
    """Registered architecture names, sorted."""
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded() -> None:
    for mod in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")
