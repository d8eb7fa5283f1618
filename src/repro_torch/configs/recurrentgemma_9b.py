"""RecurrentGemma-9B (Griffin) [arXiv:2402.19427] — hybrid: RG-LRU recurrent
blocks + local attention at a 1:2 ratio (pattern rglru,rglru,local), 38L,
d_model=4096, 16H MQA (kv=1), GeGLU d_ff=12288, vocab 256000, window 2048.

Port of ``repro.configs.recurrentgemma_9b``: the same numbers.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    source="arXiv:2402.19427",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    head_dim=256,
    sliding_window=2048,
    block_pattern=("rglru", "rglru", "local"),
    activation="geglu",
    conv_kernel=4,
    supports_long_context=True,
    param_sharding="2d",
)
