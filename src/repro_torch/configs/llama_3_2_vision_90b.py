"""llama-3.2-vision-90b -- VLM decoder with cross-attention image layers.

[hf:meta-llama/Llama-3.2-11B-Vision, the 90b dims] 100L, d_model 8192,
64 heads (GQA kv=8), d_ff 28672, vocab 128256; every 5th layer
cross-attends to the vision embeddings.  The ViT encoder and projector
are a stub: the caller gives projected patch embeddings ``(B, 1601,
8192)``.  Copied from ``repro/configs/llama_3_2_vision_90b.py``.
"""
from repro_torch.configs import base
from repro_torch.configs.base import ATTN, CROSS, ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b", family="vlm",
    source="hf:meta-llama/Llama-3.2-11B-Vision",
    n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=28672,
    vocab=128256, pattern=(ATTN, ATTN, ATTN, ATTN, CROSS),
    encoder_seq=1601, cross_attn=True, rope_theta=500_000.0,
    sharding="fsdp", supports_long_500k=False,
    grad_accum=4,
)

REDUCED = ArchConfig(
    name="llama-3.2-vision-90b-reduced", family="vlm", source=CONFIG.source,
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
    vocab=512, pattern=(ATTN, CROSS), encoder_seq=16, cross_attn=True,
    sharding="fsdp",
)

base.register(CONFIG, REDUCED)
