"""Training the towers: InfoNCE, AdamW, top-k error feedback, the trainer."""
from repro_torch.train import (compression, contrastive,  # noqa: F401
                               optimizer, trainer)
