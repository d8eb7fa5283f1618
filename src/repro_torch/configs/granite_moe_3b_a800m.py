"""Granite-3.0 MoE [hf:ibm-granite/granite-3.0-1b-a400m-base] — fine-grained
MoE: 32L, d_model=1536, 24H (kv=8), per-expert d_ff=512, vocab 49155.

Port of ``repro.configs.granite_moe_3b_a800m``: the same numbers.

NOTE (config-sheet discrepancy): the structured assignment field says
"MoE 40e top-8" while the trailing comment says "32 experts top-8".  The
reference implements the structured field: **40 experts, top-8**.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=512,                     # per-expert hidden width (fine-grained MoE)
    vocab_size=49155,
    head_dim=64,
    num_experts=40,
    num_experts_per_tok=8,
    block_pattern=("moe",),
    activation="swiglu",
    tie_embeddings=True,
    supports_long_context=True,   # long_mode: a bounded ring cache
    param_sharding="2d",
)
