"""mixtral-8x7b -- sparse MoE (8 experts, top-2) with sliding-window
attention.

[arXiv:2401.04088] 32L, d_model 4096, 32 heads (GQA kv=8), d_ff 14336,
vocab 32000, SWA window 4096.  Copied from
``repro/configs/mixtral_8x7b.py``.
"""
from repro_torch.configs import base
from repro_torch.configs.base import MOE_LOCAL, ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b", family="moe", source="arXiv:2401.04088",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=32000, pattern=(MOE_LOCAL,), window=4096,
    n_experts=8, moe_top_k=2, sharding="fsdp", supports_long_500k=True,
    grad_accum=2,
)

REDUCED = ArchConfig(
    name="mixtral-8x7b-reduced", family="moe", source=CONFIG.source,
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
    vocab=512, pattern=(MOE_LOCAL,), window=32, n_experts=4, moe_top_k=2,
    sharding="fsdp",
)

base.register(CONFIG, REDUCED)
