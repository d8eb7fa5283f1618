"""Paper-faithful acoustic model configs (Sec. 7 of the NGHF paper).

Port of ``repro.configs.base.AcousticConfig`` and ``repro.configs.
acoustic``.  RNN: two 1000-dim recurrent layers + one 1000-dim
feedforward layer, unfolded 20 steps.  LSTM: same structure with LSTM
cells.  TDNN: five 1000-dim layers with context splices
{-2..2},{-1,2},{-3,3},{-7,2},{0}.  Output layer 6000 tied triphone
states — the log-prob width ``K`` that rescoring requests carry.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class AcousticConfig:
    """Paper-faithful acoustic model geometries (Sec. 7 of the paper)."""

    name: str
    kind: str                          # rnn | lstm | tdnn | dnn
    input_dim: int = 80                # 40-dim fbank + deltas
    hidden_dim: int = 1000
    num_recurrent_layers: int = 2
    num_ff_layers: int = 1
    unfold: int = 20                   # BPTT unroll (paper: +5 .. -14)
    tdnn_contexts: Tuple[Tuple[int, ...], ...] = (
        (-2, -1, 0, 1, 2), (-1, 2), (-3, 3), (-7, 2), (0,))
    num_outputs: int = 6000            # tied triphone states
    activation: str = "sigmoid"        # sigmoid | relu

    def replace(self, **kw) -> "AcousticConfig":
        return dataclasses.replace(self, **kw)

    def smoke(self) -> "AcousticConfig":
        return self.replace(input_dim=8, hidden_dim=32, num_outputs=20,
                            unfold=5)


RNN_SIGMOID = AcousticConfig(name="rnn-sigmoid", kind="rnn",
                             activation="sigmoid")
RNN_RELU = AcousticConfig(name="rnn-relu", kind="rnn", activation="relu")
LSTM = AcousticConfig(name="lstm", kind="lstm", activation="sigmoid")
TDNN_SIGMOID = AcousticConfig(name="tdnn-sigmoid", kind="tdnn",
                              activation="sigmoid")
TDNN_RELU = AcousticConfig(name="tdnn-relu", kind="tdnn", activation="relu")

ACOUSTIC_CONFIGS = {
    c.name: c for c in (RNN_SIGMOID, RNN_RELU, LSTM, TDNN_SIGMOID, TDNN_RELU)
}

# Architecture ids (``--arch``): the "-asr" suffix keeps the acoustic namespace
# disjoint from the LLM archetype ids.
ASR_ARCHS = {
    "rnn-asr": "rnn-sigmoid",
    "rnn-relu-asr": "rnn-relu",
    "lstm-asr": "lstm",
    "tdnn-asr": "tdnn-sigmoid",
    "tdnn-relu-asr": "tdnn-relu",
}


def get_acoustic_config(arch: str) -> AcousticConfig:
    """Resolve an architecture id ("lstm-asr") or config name ("lstm")."""
    name = ASR_ARCHS.get(arch, arch)
    if name not in ACOUSTIC_CONFIGS:
        raise ValueError(
            f"unknown acoustic arch {arch!r}; expected one of "
            f"{sorted(ASR_ARCHS) + sorted(ACOUSTIC_CONFIGS)}")
    return ACOUSTIC_CONFIGS[name]
