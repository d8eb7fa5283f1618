"""Minitron-8B [arXiv:2407.14679] — width/depth-pruned Nemotron-4: 32L,
d_model=4096, 32H (GQA kv=8), d_ff=16384, vocab 256000.

Port of ``repro.configs.minitron_8b``: the same numbers.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-8b",
    family="dense",
    source="arXiv:2407.14679",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=256000,
    head_dim=128,
    activation="relu",            # nemotron uses squared-relu family; relu here
    block_pattern=("attn",),
    supports_long_context=True,   # long_mode: a bounded ring cache
    param_sharding="2d",
)
