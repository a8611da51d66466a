"""InfoNCE bi-encoder training — how the metric towers (d and D) are made.
The counterpart of ``repro.train.contrastive``.

In-batch-negative symmetric InfoNCE, the standard recipe for the embedding
models the paper uses (bge/gte/SFR are all trained this way). The towers'
attention differentiates through the hand-written ``flash_attention``
backward kernel on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.backend import as_tensor
from repro_torch.models import transformer


def info_nce_loss(model: transformer.Transformer, batch: dict, *,
                  temperature: float = 0.05) -> tuple[torch.Tensor, dict]:
    """``batch``: ``query_tokens`` and ``doc_tokens``, (B, S) ids (numpy
    arrays or tensors; moved to the model's device). Returns (loss,
    {"loss", "acc"}), JAX's order of operations."""
    dev = model.embed.device
    q = transformer.embed_pool(model, as_tensor(batch["query_tokens"], dev))
    d = transformer.embed_pool(model, as_tensor(batch["doc_tokens"], dev))
    logits = (q @ d.T) / temperature  # (B, B) — in-batch negatives
    labels = torch.arange(q.shape[0], device=dev)
    lse_q = torch.logsumexp(logits, dim=1)
    lse_d = torch.logsumexp(logits, dim=0)
    diag = torch.diagonal(logits)
    loss = ((lse_q - diag).mean() + (lse_d - diag).mean()) / 2
    acc = (logits.argmax(dim=1) == labels).float().mean()
    return loss, {"loss": loss.detach(), "acc": acc}
