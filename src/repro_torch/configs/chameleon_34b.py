"""Chameleon-34B [arXiv:2405.09818] — early-fusion VLM, 48L, d_model=8192,
64H (GQA kv=8), d_ff=22016, vocab 65536 (includes VQ image tokens), qk-norm.

The frontend is a stub: Chameleon's images are VQ-VAE token ids in the
shared 65 536 vocab, so the stubbed frontend is the VQ tokenizer itself
and ``input_specs()`` supplies mixed text+image *token ids* directly.
The language backbone is full.

Port of ``repro.configs.chameleon_34b``: the same numbers.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b",
    family="vlm",
    source="arXiv:2405.09818",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    head_dim=128,
    qk_norm=True,
    block_pattern=("attn",),
    supports_long_context=True,   # long_mode: a bounded ring cache
    param_sharding="2d",
)
