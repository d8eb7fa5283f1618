"""Model registry: binds an ArchConfig to a uniform Model API.

Port of ``repro.models.registry``.  Model(cfg) exposes:
    init(seed, device)                              -> params
    forward(params, batch)                          -> (logits, aux)
    forward_hidden(params, batch)                   -> (hidden, aux)
    head_matrix(params)                             -> (d, V)
    init_cache(batch, cache_len, device)            -> cache
    decode_step(params, cache, tokens, pos)         -> (logits, cache)
    param_shapes() / param_count()                  -> by shape only

The reference's ``input_specs`` (dry-run stand-ins) and ``share_counts``
(the CG preconditioner of LM training) come with the LM training slice.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DEFAULT_DEVICE
from repro_torch.models import transformer


class Model:
    def __init__(self, cfg: ArchConfig):
        transformer.check_ported(cfg)
        self.cfg = cfg
        self._mod = transformer

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

    def init_cache(self, batch: int, cache_len: int, *,
                   device=DEFAULT_DEVICE):
        return self._mod.init_cache(self.cfg, batch, cache_len,
                                    device=device)

    def decode_step(self, params, cache, tokens, pos):
        return self._mod.decode_step(self.cfg, params, cache, tokens, pos)


def get_model(cfg: ArchConfig) -> Model:
    return Model(cfg)
