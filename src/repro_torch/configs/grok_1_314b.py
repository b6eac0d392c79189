"""grok-1-314b -- large sparse MoE (8 experts, top-2), full attention.

[hf:xai-org/grok-1] 64L, d_model 6144, 48 heads (GQA kv=8), d_ff 32768,
vocab 131072.  Trained with bfloat16 master weights and compute and
8-bit Adam moments, over 4 accumulated micro-batches.  Copied from
``repro/configs/grok_1_314b.py``.
"""
from repro_torch.configs import base
from repro_torch.configs.base import MOE, ArchConfig
from repro_torch.core.qconfig import MixedPrecisionConfig

CONFIG = ArchConfig(
    name="grok-1-314b", family="moe", source="hf:xai-org/grok-1",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=32768,
    vocab=131072, pattern=(MOE,), n_experts=8, moe_top_k=2,
    sharding="fsdp", optimizer_8bit=True, supports_long_500k=False,
    grad_accum=4,
    mp=MixedPrecisionConfig(compute_dtype="bfloat16", param_dtype="bfloat16"),
)

REDUCED = ArchConfig(
    name="grok-1-314b-reduced", family="moe", source=CONFIG.source,
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
    vocab=512, pattern=(MOE,), n_experts=4, moe_top_k=2,
    sharding="fsdp", optimizer_8bit=True,
)

base.register(CONFIG, REDUCED)
