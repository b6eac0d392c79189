"""gemma2-9b -- alternating local/global attention with logit soft-capping.

[arXiv:2408.00118] 42L, d_model 3584, 16 heads (GQA kv=8, head_dim 256),
d_ff 14336, vocab 256000, window 4096 on local layers, attention
soft-cap 50, final soft-cap 30, tied embeddings.  Copied from
``repro/configs/gemma2_9b.py``.
"""
from repro_torch.configs import base
from repro_torch.configs.base import ATTN, ATTN_LOCAL, ArchConfig

CONFIG = ArchConfig(
    name="gemma2-9b", family="dense", source="arXiv:2408.00118",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8, d_ff=14336,
    vocab=256000, head_dim=256, pattern=(ATTN_LOCAL, ATTN), window=4096,
    softcap=50.0, final_softcap=30.0, tie_embeddings=True,
    sharding="fsdp", supports_long_500k=True,
    grad_accum=2,
)

REDUCED = ArchConfig(
    name="gemma2-9b-reduced", family="dense", source=CONFIG.source,
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
    vocab=512, head_dim=32, pattern=(ATTN_LOCAL, ATTN), window=32,
    softcap=50.0, final_softcap=30.0, tie_embeddings=True, sharding="fsdp",
)

base.register(CONFIG, REDUCED)
