"""Mixtral-8x22B [arXiv:2401.04088] — 56L MoE (8 experts, top-2) with
sliding-window attention (window 4096).  SWA makes long_500k legal natively.

Port of ``repro.configs.mixtral_8x22b``: the same numbers.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    source="arXiv:2401.04088",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    head_dim=128,
    num_experts=8,
    num_experts_per_tok=2,
    sliding_window=4096,
    block_pattern=("swamoe",),
    rope_theta=1_000_000.0,
    supports_long_context=True,
    param_sharding="2d",
    # The reference's note: moe_impl="dispatch" was tried and refuted
    # under GSPMD — a global argsort/gather dispatch across the
    # data-sharded batch costs 10x more in collectives (66 TB/dev) than
    # the 4x dense compute waste it saves.  A shard_map expert-parallel
    # all-to-all dispatch is the production answer; the dense one-hot
    # form stays the default here.
    moe_impl="dense",
)
