"""Model registry: binds an ArchConfig to a uniform Model API.

Port of ``repro.models.registry``.  Model(cfg) exposes:
    init(seed, device)                              -> params
    forward(params, batch)                          -> (logits, aux)
    forward_hidden(params, batch)                   -> (hidden, aux)
    head_matrix(params)                             -> (d, V)
    init_cache(batch, cache_len, long_mode, device, mesh) -> cache
    cache_shapes(batch, cache_len, long_mode)       -> by shape only
    decode_step(params, cache, tokens, pos, long_mode) -> (logits, cache)
    param_shapes() / param_count()                  -> by shape only
    input_specs(shape_name)                         -> {name: (shape, dtype)}
    share_counts(params)                            -> {path: count}

An encoder-decoder config (``cfg.is_encoder_decoder``) runs
``models.encdec``, every other one ``models.transformer``; each refuses
the options it does not run yet.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import INPUT_SHAPES, ArchConfig
from repro_torch.device import DEFAULT_DEVICE
from repro_torch.models import encdec, transformer


class Model:
    def __init__(self, cfg: ArchConfig):
        self._mod = encdec if cfg.is_encoder_decoder else transformer
        self._mod.check_ported(cfg)
        self.cfg = cfg

    # --- parameters --------------------------------------------------------
    def init(self, seed: int = 0, device=DEFAULT_DEVICE):
        return self._mod.init_params(self.cfg, seed, device)

    def param_shapes(self):
        return self._mod.param_shapes(self.cfg)

    def param_count(self) -> int:
        return self._mod.param_count(self.cfg)

    # --- compute -----------------------------------------------------------
    def forward(self, params, batch):
        return self._mod.forward(self.cfg, params, batch)

    def forward_hidden(self, params, batch):
        """(hidden (B,T,d), aux) — pre-LM-head, for chunked-vocab losses."""
        return self._mod.forward_hidden(self.cfg, params, batch)

    def head_matrix(self, params):
        return self._mod.head_matrix(self.cfg, params)

    def init_cache(self, batch: int, cache_len: int, *, long_mode=False,
                   device=DEFAULT_DEVICE, mesh=None):
        """Zeroed decode caches; on a ``mesh`` this rank's shares of them
        (``launch.sharding.place_cache``)."""
        return self._mod.init_cache(self.cfg, batch, cache_len,
                                    long_mode=long_mode, device=device,
                                    mesh=mesh)

    def cache_shapes(self, batch: int, cache_len: int, *, long_mode=False):
        """{path: (shape, dtype)} of the whole decode cache."""
        return self._mod.cache_shapes(self.cfg, batch, cache_len,
                                      long_mode=long_mode)

    def decode_step(self, params, cache, tokens, pos, *, long_mode=False):
        return self._mod.decode_step(self.cfg, params, cache, tokens, pos,
                                     long_mode=long_mode)

    # --- input stand-ins ---------------------------------------------------
    def input_specs(self, shape_name: str) -> dict:
        """{name: (shape, dtype)} of a step's inputs at ``shape_name``
        (``configs.base.INPUT_SHAPES``), built without allocating (a
        decode shape's cache on the meta device; long_500k's is the
        bounded ``long_mode`` cache)."""
        cfg = self.cfg
        shp = INPUT_SHAPES[shape_name]
        B, T = shp.global_batch, shp.seq_len
        if shp.mode in ("train", "prefill"):
            specs = {"tokens": ((B, T), torch.int32)}
            if shp.mode == "train":
                specs["labels"] = ((B, T), torch.int32)
            if cfg.is_encoder_decoder:
                # the stubbed frontend: precomputed frame embeddings
                specs["encoder_input"] = (
                    (B, cfg.encoder_frames, cfg.d_model), cfg.cdtype)
            return specs
        # decode: ONE new token against a cache of seq_len
        return {"tokens": ((B, 1), torch.int32), "pos": ((), torch.int32),
                "cache": self._mod.cache_shapes(
                    cfg, B, T, long_mode=shp.name == "long_500k")}

    # --- shared-parameter counts (Sec. 4.3) --------------------------------
    def share_counts(self, params) -> dict:
        """Per-path counts of ``params`` (a parameter dict or
        ``param_shapes()``) for the CG preconditioner: ``share_counts``."""
        return share_counts(self.cfg, params)


def share_counts(cfg: ArchConfig, paths) -> dict:
    """Relative per-sample application counts for the CG preconditioner,
    one Python float per parameter path.

    Every weight of an LM is applied once per token (count 1), with three
    exceptions, as in the reference:
      * MoE expert weights (``w_in``/``w_out``/``w_gate`` under a ``moe``
        node): expected usage top_k / E per token;
      * enc-dec: encoder weights are applied ``encoder_frames`` times per
        sample against T_dec for the decoder's, folded in as the static
        ratio encoder_frames / 1024;
      * tied embeddings: the table is applied twice per token (input
        embedding and output head), count 2.
    """
    def count(path: str) -> float:
        keys = path.split(".")
        if cfg.num_experts and "moe" in keys and any(
                k in ("w_in", "w_out", "w_gate") for k in keys):
            return cfg.num_experts_per_tok / cfg.num_experts
        if cfg.is_encoder_decoder and "encoder" in keys:
            return cfg.encoder_frames / 1024.0
        if cfg.tie_embeddings and "table" in keys:
            return 2.0
        return 1.0

    return {k: count(k) for k in paths}


def get_model(cfg: ArchConfig) -> Model:
    return Model(cfg)
