"""stablelm-12b -- dense GQA decoder.

[hf:stabilityai/stablelm-2-1_6b family, 12b dims] 40L, d_model 5120, 32
heads (GQA kv=8, head dim 160), d_ff 13824, vocab 100352.  Copied from
``repro/configs/stablelm_12b.py``.
"""
from repro_torch.configs import base
from repro_torch.configs.base import ATTN, ArchConfig

CONFIG = ArchConfig(
    name="stablelm-12b", family="dense",
    source="hf:stabilityai/stablelm-2-1_6b",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, d_ff=13824,
    vocab=100352, pattern=(ATTN,), sharding="fsdp",
    grad_accum=2,
    supports_long_500k=False,
)

REDUCED = ArchConfig(
    name="stablelm-12b-reduced", family="dense", source=CONFIG.source,
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
    vocab=512, pattern=(ATTN,), sharding="fsdp",
)

base.register(CONFIG, REDUCED)
