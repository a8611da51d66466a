"""Core bi-metric similarity-search library (the paper's contribution)."""
from repro_torch.core import beam, bimetric, distances, metrics, vamana  # noqa: F401
