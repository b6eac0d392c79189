"""xlstm-125m -- alternating mLSTM + sLSTM blocks (attention-free).

[arXiv:2405.04517] 12L, d_model 768, 4 heads, d_ff 0 (the xLSTM cell has
its own projections and no separate FFN), vocab 50304.  Copied from
``repro/configs/xlstm_125m.py``.
"""
from repro_torch.configs import base
from repro_torch.configs.base import MLSTM, SLSTM, ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m", family="ssm", source="arXiv:2405.04517",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab=50304, pattern=(MLSTM, SLSTM), head_dim=192,
    sharding="tp", supports_long_500k=True,
)

REDUCED = ArchConfig(
    name="xlstm-125m-reduced", family="ssm", source=CONFIG.source,
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab=512, pattern=(MLSTM, SLSTM), head_dim=32, sharding="tp",
)

base.register(CONFIG, REDUCED)
