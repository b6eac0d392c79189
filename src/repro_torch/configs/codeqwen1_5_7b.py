"""codeqwen1.5-7b -- dense decoder, full multi-head attention (kv ==
heads).

[hf:Qwen/CodeQwen1.5-7B] 32L, d_model 4096, 32 heads (kv=32), d_ff
13440, vocab 92416, rope theta 1e6.  Copied from
``repro/configs/codeqwen1_5_7b.py``.
"""
from repro_torch.configs import base
from repro_torch.configs.base import ATTN, ArchConfig

CONFIG = ArchConfig(
    name="codeqwen1.5-7b", family="dense", source="hf:Qwen/CodeQwen1.5-7B",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32, d_ff=13440,
    vocab=92416, pattern=(ATTN,), rope_theta=1_000_000.0,
    sharding="fsdp", supports_long_500k=False,
    grad_accum=2,
)

REDUCED = ArchConfig(
    name="codeqwen1.5-7b-reduced", family="dense", source=CONFIG.source,
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
    vocab=512, pattern=(ATTN,), sharding="fsdp",
)

base.register(CONFIG, REDUCED)
