"""h2o-danube-1.8b -- llama+mistral mix with sliding-window attention.

[arXiv:2401.16818] 24L, d_model 2560, 32 heads (GQA kv=8), d_ff 6912,
vocab 32000, Mistral-style SWA (window 4096 at this scale).  Copied from
``repro/configs/h2o_danube_1_8b.py``.
"""
from repro_torch.configs import base
from repro_torch.configs.base import ATTN_LOCAL, ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-1.8b", family="dense", source="arXiv:2401.16818",
    n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8, d_ff=6912,
    vocab=32000, pattern=(ATTN_LOCAL,), window=4096,
    sharding="tp", supports_long_500k=True,  # SWA caps the decode cache
)

REDUCED = ArchConfig(
    name="h2o-danube-1.8b-reduced", family="dense", source=CONFIG.source,
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
    vocab=512, pattern=(ATTN_LOCAL,), window=32, sharding="tp",
)

base.register(CONFIG, REDUCED)
