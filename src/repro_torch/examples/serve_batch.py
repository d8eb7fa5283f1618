"""Batched serving example: continuous decode over a recurrent (xLSTM)
model, O(1) state per token: the long_500k-capable path.

    PYTHONPATH=src python -m repro_torch.examples.serve_batch [--device cpu]

Port of ``examples/serve_batch.py``: ``launch.serve.main`` with the
reference's arguments on xlstm-125m's smoke config, plus ``--device``.
"""
from __future__ import annotations

import argparse

from repro_torch.device import DEFAULT_DEVICE
from repro_torch.launch.serve import main as serve_main

ARGS = ["--arch", "xlstm-125m", "--smoke", "--requests", "4",
        "--max-new", "12", "--cache-len", "64"]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return serve_main(ARGS + ["--device", args.device])


if __name__ == "__main__":
    main()
