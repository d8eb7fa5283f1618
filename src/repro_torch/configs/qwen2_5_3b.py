"""Qwen2.5-3B [hf:Qwen/Qwen2.5-0.5B geometry family] — dense, GQA (kv=2),
QKV bias.

Port of ``repro.configs.qwen2_5_3b``: the same numbers.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-3b",
    family="dense",
    source="hf:Qwen/Qwen2.5-0.5B",
    num_layers=36,
    d_model=2048,
    num_heads=16,
    num_kv_heads=2,
    d_ff=11008,
    vocab_size=151936,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    block_pattern=("attn",),
    tie_embeddings=True,
    supports_long_context=True,   # long_mode: a bounded ring cache
    param_sharding="2d",
)
