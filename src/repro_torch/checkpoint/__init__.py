"""Checkpoints in the reference's npz + manifest format (port of
``repro.checkpoint``)."""
