"""whisper-tiny -- encoder-decoder audio transformer (conv frontend a stub).

[arXiv:2212.04356] 4L encoder + 4L decoder, d_model 384, 6 heads, d_ff
1536, vocab 51865, LayerNorm and GeLU.  The mel and conv frontend is a
stub: the caller gives precomputed frame embeddings ``(B, 1500, 384)``;
the transformer encoder runs over them and every decoder layer
cross-attends to its output.  Copied from
``repro/configs/whisper_tiny.py``.
"""
from repro_torch.configs import base
from repro_torch.configs.base import CROSS, ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny", family="audio", source="arXiv:2212.04356",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6, d_ff=1536,
    vocab=51865, pattern=(CROSS,), norm="layer", activation="gelu",
    encoder_layers=4, encoder_seq=1500, cross_attn=True, rope_theta=10000.0,
    sharding="tp", supports_long_500k=False,  # full-attention decoder
)

REDUCED = ArchConfig(
    name="whisper-tiny-reduced", family="audio", source=CONFIG.source,
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
    vocab=512, pattern=(CROSS,), norm="layer", activation="gelu",
    encoder_layers=2, encoder_seq=16, cross_attn=True, sharding="tp",
)

base.register(CONFIG, REDUCED)
