"""Step builders and the training driver (single device).  Port of the
sequence-training half of ``repro.launch``."""
