"""Architecture configuration of the language models.

Port of ``repro.configs.base`` (``ArchConfig``, ``VALID_BLOCKS``,
``InputShape``/``INPUT_SHAPES`` and the arch registry).  Dtypes stay
strings, as in the reference; ``cdtype``/``pdtype`` return torch dtypes.
The registry knows the archs the port runs (since the xLSTM slice, the
reference's whole pool); any other arch raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

# ---------------------------------------------------------------------------
# Block kinds used in ``block_pattern``.  The pattern is cycled over the depth
# of the network (``models.transformer.layer_plan``).
#   "attn"   - global (causal) self attention + dense FFN
#   "swa"    - sliding-window self attention + FFN
#   "moe"    - global attention + mixture-of-experts FFN
#   "swamoe" - sliding-window attention + MoE FFN
#   "rglru"  - RG-LRU (Griffin) recurrent block + FFN
#   "local"  - local (windowed) attention + FFN (RecurrentGemma style)
#   "mlstm"  - xLSTM matrix-memory block (self contained, has own proj)
#   "slstm"  - xLSTM scalar-memory recurrent block
# ---------------------------------------------------------------------------

VALID_BLOCKS = ("attn", "swa", "moe", "swamoe", "rglru", "local", "mlstm", "slstm")


@dataclass(frozen=True)
class ArchConfig:
    """Static description of one architecture."""

    name: str
    family: str                       # dense | moe | ssm | hybrid | audio | vlm
    source: str                       # citation for the geometry
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None    # default: d_model // num_heads
    block_pattern: Tuple[str, ...] = ("attn",)

    # --- attention options ----------------------------------------------
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    rotary_pct: float = 1.0           # stablelm uses partial rotary
    sliding_window: Optional[int] = None   # for "swa"/"local" blocks
    # the reference's bounded-cache variant for long_500k decode of the
    # dense archs
    long_context_window: int = 8192

    # --- FFN / MoE --------------------------------------------------------
    activation: str = "swiglu"        # swiglu | geglu | gelu | relu
    num_experts: int = 0
    num_experts_per_tok: int = 0
    router_aux_coef: float = 0.01
    moe_impl: str = "dense"           # dense | dispatch

    # --- norms / embeddings ----------------------------------------------
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    tie_embeddings: bool = False
    max_position_embeddings: int = 1 << 20

    # --- encoder-decoder (whisper) ----------------------------------------
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_frames: int = 1500
    learned_positions: bool = False

    # --- xLSTM -------------------------------------------------------------
    proj_factor: float = 2.0          # xLSTM block up-projection factor
    conv_kernel: int = 4              # short conv inside mLSTM/RG-LRU blocks

    # --- RG-LRU ------------------------------------------------------------
    rglru_dim: Optional[int] = None   # recurrent width (default d_model)

    # --- numerics / distribution ------------------------------------------
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    param_sharding: str = "2d"        # 2d | 1d | replicated
    remat: str = "full"               # none | full
    scan_layers: bool = True

    # --- capability flags --------------------------------------------------
    supports_long_context: bool = False   # sub-quadratic path available
    decode_capable: bool = True           # False for encoder-only archs

    def __post_init__(self):
        for b in self.block_pattern:
            if b not in VALID_BLOCKS:
                raise ValueError(f"unknown block kind {b!r}")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    # The per-arch reduced variant used by CPU smoke tests (2 layers,
    # d_model <= 512, <= 4 experts) -- same family/block pattern.
    def smoke(self) -> "ArchConfig":
        d = min(self.d_model, 128)
        heads = min(self.num_heads, 4)
        kv = min(self.num_kv_heads, heads)
        while heads % kv:
            kv -= 1
        n_layers = max(2, len(self.block_pattern))
        kw = dict(
            num_layers=n_layers,
            encoder_layers=min(self.encoder_layers, 2),
            d_model=d,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=max(d // heads, 8),
            d_ff=min(self.d_ff, 256) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            encoder_frames=min(self.encoder_frames, 16),
            sliding_window=min(self.sliding_window, 16) if self.sliding_window else None,
            long_context_window=64,
            num_experts=min(self.num_experts, 4),
            num_experts_per_tok=min(self.num_experts_per_tok, 2),
            param_sharding="replicated",
            remat="none",
            rglru_dim=None,
        )
        return self.replace(**kw)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

# CLI ids (with dashes/dots) -> module names, for the archs the port runs
_ALIASES = {
    "recurrentgemma-9b": "recurrentgemma_9b",
    "whisper-base": "whisper_base",
    "stablelm-1.6b": "stablelm_1_6b",
    "qwen2.5-3b": "qwen2_5_3b",
    "minitron-8b": "minitron_8b",
    "chameleon-34b": "chameleon_34b",
    "qwen2-72b": "qwen2_72b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "mixtral-8x22b": "mixtral_8x22b",
    "xlstm-125m": "xlstm_125m",
}

# the rest of the reference's pool: not ported yet (none since the xLSTM
# slice; an arch added to the reference's pool is named here until ported)
NOT_PORTED = ()


def get_config(arch: str) -> ArchConfig:
    mod_name = _ALIASES.get(arch)
    if mod_name is None and arch in _ALIASES.values():
        mod_name = arch
    if mod_name is None:
        known = arch in NOT_PORTED or arch.replace("_", "-") in NOT_PORTED
        raise NotImplementedError(
            f"arch {arch!r} is {'not ported yet' if known else 'unknown'}; "
            f"the port runs {list_archs()} (ROADMAP.md lists the archs "
            f"still to port)")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def list_archs():
    return list(_ALIASES.keys())


# ---------------------------------------------------------------------------
# Input shapes
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str                          # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
