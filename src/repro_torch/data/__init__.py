"""Synthetic bi-metric corpora."""
