"""Plain PyTorch oracles for the search kernels (the correctness contract).

Each ``<name>_ref`` is the definition its Hopper kernel must match, written
as the JAX package's ``repro.kernels.ref`` writes it. These are also the
plain versions the kernel wrappers run on CPU tensors.
"""
from __future__ import annotations

import torch

_EPS = 1e-12


def _score_rows(rows: torch.Tensor, queries: torch.Tensor, ids: torch.Tensor,
                metric: str) -> torch.Tensor:
    """Gather-then-reduce score of f32 rows (B, K, dim) against queries."""
    q = queries[:, None].float()  # (B, 1, dim)
    if metric in ("l2", "sqeuclidean"):
        diff = rows - q
        d = (diff * diff).sum(-1)
        if metric == "l2":
            d = torch.sqrt(d)
    elif metric == "ip":
        d = -(rows * q).sum(-1)
    elif metric == "cosine":
        qn = torch.rsqrt((q * q).sum(-1) + _EPS)
        rn = torch.rsqrt((rows * rows).sum(-1) + _EPS)
        d = 1.0 - (rows * q).sum(-1) * qn * rn
    else:
        raise ValueError(f"unknown metric {metric!r}")
    return torch.where(ids >= 0, d, torch.full_like(d, float("inf")))


def gather_score_ref(corpus: torch.Tensor, queries: torch.Tensor,
                     ids: torch.Tensor,
                     metric: str = "sqeuclidean") -> torch.Tensor:
    """corpus (N, dim); queries (B, dim); ids (B, K) -> (B, K) f32.

    ids < 0 -> +inf. "ip" is negated, "cosine" one-minus.
    """
    rows = corpus[ids.clamp(min=0).long()].float()  # (B, K, dim)
    return _score_rows(rows, queries, ids, metric)


def dequant_rows_ref(rows: torch.Tensor, scales: torch.Tensor,
                     zero_points: torch.Tensor | None = None) -> torch.Tensor:
    """THE dequantization semantics: f32 ``(code - zp) * scale``."""
    f = rows.float()
    if zero_points is not None:
        f = f - zero_points[..., None].float()
    return f * scales[..., None].float()


def gather_score_quant_ref(rows: torch.Tensor, scales: torch.Tensor,
                           zero_points: torch.Tensor | None,
                           queries: torch.Tensor, ids: torch.Tensor,
                           metric: str = "sqeuclidean") -> torch.Tensor:
    """:func:`gather_score_ref` over :func:`dequant_rows_ref` of the rows."""
    safe = ids.clamp(min=0).long()
    zp = None if zero_points is None else zero_points[safe]
    deq = dequant_rows_ref(rows[safe], scales[safe], zp)  # (B, K, dim)
    return _score_rows(deq, queries, ids, metric)


def beam_merge_topk_ref(beam_ids, beam_dists, cand_ids, cand_dists):
    """Merge (B, L) beam with (B, K) candidates, best (B, L) by dist."""
    L = beam_ids.shape[1]
    ids = torch.cat([beam_ids, cand_ids], dim=1)
    d = torch.cat([beam_dists, cand_dists], dim=1)
    order = torch.argsort(d, dim=1, stable=True)[:, :L]
    return ids.gather(1, order), d.gather(1, order)


def merge_pool_batch_ref(pool_ids, pool_dists, expanded, cand_ids,
                         cand_dists):
    """Stable (beam ‖ fanout) merge keeping the best pool-width per query.

    The ``expanded`` payload rides along (candidates enter unexpanded). Ties
    — +inf padding included — keep the earlier position, so merging an
    all-masked wave is an exact no-op.
    """
    p = pool_ids.shape[1]
    ids = torch.cat([pool_ids, cand_ids], dim=1)
    d = torch.cat([pool_dists, cand_dists], dim=1)
    exp = torch.cat([expanded, torch.zeros_like(cand_ids, dtype=torch.bool)],
                    dim=1)
    order = torch.argsort(d, dim=1, stable=True)[:, :p]
    take = lambda a: a.gather(1, order)
    return take(ids), take(d), take(exp)
