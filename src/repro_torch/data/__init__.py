"""Deterministic synthetic data (``data.synthetic``) and batches under a
mesh (``data.pipeline``)."""
