"""Retrieval quality metrics: Recall@k and NDCG@k (paper §4.1 "Metric")."""
from __future__ import annotations

import torch


def recall_at_k(pred_ids: torch.Tensor, true_ids: torch.Tensor) -> torch.Tensor:
    """Recall@k of predicted ids vs ground-truth ids. (B,k),(B,k) -> (B,)."""
    hits = (pred_ids[:, :, None] == true_ids[:, None, :]) & (
        pred_ids[:, :, None] >= 0)
    return hits.any(dim=2).sum(dim=1).float() / true_ids.shape[1]


def dcg(gains: torch.Tensor) -> torch.Tensor:
    """(B, k) gains in rank order -> (B,) discounted cumulative gain."""
    ranks = torch.arange(gains.shape[1], dtype=torch.float32,
                         device=gains.device)
    disc = 1.0 / torch.log2(ranks + 2.0)
    return (gains * disc[None, :]).sum(dim=1)


def ndcg_at_k(pred_ids: torch.Tensor, true_ids: torch.Tensor,
              true_gains: torch.Tensor | None = None) -> torch.Tensor:
    """NDCG@k against graded ground truth (default grades k, k-1, ..., 1)."""
    b, k = true_ids.shape
    if true_gains is None:
        true_gains = torch.arange(k, 0, -1, dtype=torch.float32,
                                  device=true_ids.device)[None, :].expand(b, k)
    match = (pred_ids[:, :, None] == true_ids[:, None, :]) & (
        pred_ids[:, :, None] >= 0)
    pred_gain = (match * true_gains[:, None, :]).sum(dim=2)  # (B, k_pred)
    ideal = dcg(true_gains)
    return dcg(pred_gain[:, :k]) / torch.clamp(ideal, min=1e-9)
