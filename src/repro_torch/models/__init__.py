"""The embedding towers' layers and transformer (dense GQA)."""
from repro_torch.models import layers, transformer  # noqa: F401
