"""Qwen2-72B [arXiv:2407.10671] — dense, GQA (kv=8), QKV bias.

Port of ``repro.configs.qwen2_72b``: the same numbers.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-72b",
    family="dense",
    source="arXiv:2407.10671",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    block_pattern=("attn",),
    # dense full-attention arch: long_500k decodes over a ring of
    # long_context_window slots (``serve``'s long_mode)
    supports_long_context=True,
    long_context_window=8192,
)
