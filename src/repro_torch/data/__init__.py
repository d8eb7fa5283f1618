"""Deterministic synthetic data (``data.synthetic``)."""
