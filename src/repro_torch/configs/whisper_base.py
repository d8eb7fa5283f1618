"""Whisper-base [arXiv:2212.04356] — encoder-decoder audio model: 6
encoder + 6 decoder layers, d_model=512, 8 heads, GELU d_ff=2048,
LayerNorm, learned decoder positions, vocab 51865.

Port of ``repro.configs.whisper_base``: the same numbers.  The mel +
conv frontend is a stub in both packages: the encoder consumes frame
embeddings of shape (batch, encoder_frames, d_model).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base",
    family="audio",
    source="arXiv:2212.04356",
    num_layers=6,                # decoder layers
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    head_dim=64,
    activation="gelu",
    norm="layernorm",
    learned_positions=True,
    is_encoder_decoder=True,
    encoder_layers=6,
    encoder_frames=1500,
    block_pattern=("attn",),
    supports_long_context=False,
    param_sharding="1d",
)
