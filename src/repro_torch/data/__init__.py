"""Synthetic bi-metric corpora and the deterministic batch pipeline."""
