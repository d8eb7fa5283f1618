"""Acoustic models of the paper (``models.acoustic``)."""
