"""xLSTM-125M [arXiv:2405.04517] — sLSTM + mLSTM blocks, 12L, d_model=768,
4 heads, no separate FFN (d_ff=0; blocks carry their own up/down projections
with proj_factor=2).  Block pattern approximates the paper's mLSTM-dominant
xLSTM[7:1]-style mix with one sLSTM per 4-block period.

Fully recurrent => O(1) decode state; long_500k runs natively.

Port of ``repro.configs.xlstm_125m``: the same numbers.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    source="arXiv:2405.04517",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    head_dim=192,
    block_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
    proj_factor=2.0,
    conv_kernel=4,
    norm="layernorm",
    tie_embeddings=True,
    supports_long_context=True,
    param_sharding="1d",
)
