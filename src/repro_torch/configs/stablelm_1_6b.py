"""StableLM-2-1.6B [hf:stabilityai/stablelm-2-1_6b] — dense, LayerNorm,
partial rotary embeddings (rotary_pct=0.25), MHA (kv=32).

Port of ``repro.configs.stablelm_1_6b``: the same numbers.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-1.6b",
    family="dense",
    source="hf:stabilityai/stablelm-2-1_6b",
    num_layers=24,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=5632,
    vocab_size=100352,
    head_dim=64,
    norm="layernorm",
    rotary_pct=0.25,
    activation="swiglu",
    block_pattern=("attn",),
    supports_long_context=True,     # long_mode: a bounded ring cache
    param_sharding="2d",
)
