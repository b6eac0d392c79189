"""recurrentgemma-2b -- Griffin: RG-LRU recurrence + local attention, 2:1.

[arXiv:2402.19427] 26L, d_model 2560, 10 heads (MQA kv=1, head_dim 256),
d_ff 7680, vocab 256000, window 2048 on attention layers, tied
embeddings.  Pattern (rglru, rglru, attn_local) x 8 + (rglru, rglru)
remainder = 26.  Copied from ``repro/configs/recurrentgemma_2b.py``.
"""
from repro_torch.configs import base
from repro_torch.configs.base import ATTN_LOCAL, RGLRU, ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b", family="hybrid", source="arXiv:2402.19427",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, d_ff=7680,
    vocab=256000, head_dim=256, pattern=(RGLRU, RGLRU, ATTN_LOCAL),
    window=2048, tie_embeddings=True, sharding="tp",
    supports_long_500k=True,
)

REDUCED = ArchConfig(
    name="recurrentgemma-2b-reduced", family="hybrid", source=CONFIG.source,
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=1, d_ff=256,
    vocab=512, head_dim=32, pattern=(RGLRU, ATTN_LOCAL), window=32,
    tie_embeddings=True, sharding="tp",
)

base.register(CONFIG, REDUCED)
