"""Distance functions for the bi-metric framework (PyTorch).

``EmbeddingMetric`` scores (query, doc-id) pairs against a fixed embedding
matrix in gather-then-reduce form through ``l2_topk.gather_score``: the
hand-written kernel on a CUDA corpus, its plain version on a CPU one.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import l2_topk

VALID_METRICS = ("l2", "sqeuclidean", "ip", "cosine")


def _check(metric: str) -> None:
    if metric not in VALID_METRICS:
        raise ValueError(f"metric must be one of {VALID_METRICS}, got {metric!r}")


def pairwise(x: torch.Tensor, y: torch.Tensor, metric: str = "l2") -> torch.Tensor:
    """Pairwise dissimilarity between rows of ``x`` (..., n, dim) and ``y``
    (..., m, dim) -> (..., n, m), in matmul form. "ip"/"cosine" are negated /
    one-minus so that smaller is always better."""
    _check(metric)
    x = x.float()
    y = y.float()
    yt = y.transpose(-1, -2)
    if metric in ("l2", "sqeuclidean"):
        x2 = (x * x).sum(-1, keepdim=True)
        y2 = (y * y).sum(-1, keepdim=True)
        sq = torch.clamp(x2 + y2.transpose(-1, -2) - 2.0 * (x @ yt), min=0.0)
        return sq if metric == "sqeuclidean" else torch.sqrt(sq)
    if metric == "ip":
        return -(x @ yt)
    xn = x * torch.rsqrt((x * x).sum(-1, keepdim=True) + 1e-12)
    yn = y * torch.rsqrt((y * y).sum(-1, keepdim=True) + 1e-12)
    return 1.0 - xn @ yn.transpose(-1, -2)


def point_to_points(q: torch.Tensor, xs: torch.Tensor,
                    metric: str = "l2") -> torch.Tensor:
    """Distance from one query (dim,) to the rows of ``xs`` (m, dim) -> (m,)."""
    return pairwise(q[None, :], xs, metric)[0]


class EmbeddingMetric:
    """A dissimilarity backed by a fixed (N, dim) embedding matrix."""

    def __init__(self, embeddings: torch.Tensor, metric: str = "l2"):
        _check(metric)
        self.embeddings = embeddings
        self.metric = metric

    @property
    def n(self) -> int:
        return self.embeddings.shape[0]

    @property
    def dim(self) -> int:
        return self.embeddings.shape[1]

    def embed_query(self, q: torch.Tensor) -> torch.Tensor:
        """The query's embedding: ``q`` itself (the embeddings are
        precomputed)."""
        return q

    def dists_batch(self, q_embs: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """(B, dim), (B, k) -> (B, k); ids < 0 -> +inf.

        Gather-then-reduce form: a lane's value depends only on its (query,
        row) pair, which the batched engine relies on for bit-exact parity
        between batched and single-query runs.
        """
        return l2_topk.gather_score(self.embeddings, q_embs,
                                    ids.to(torch.int32), metric=self.metric)

    def dists(self, q_emb: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """(dim,), (k,) -> (k,)."""
        return self.dists_batch(q_emb[None], ids[None])[0]

    def brute_force(self, q_embs: torch.Tensor, k: int):
        """Exact top-k (ids int32, dists) per query row, ties to the lowest
        index."""
        d = pairwise(q_embs, self.embeddings, self.metric)
        dists, ids = torch.sort(d, dim=1, stable=True)
        return ids[:, :k].to(torch.int32), dists[:, :k]


def dist_fn_from_embeddings(embeddings: torch.Tensor, metric: str = "l2"):
    """``dist(q_emb (dim,), ids (k,)) -> (k,)`` over fixed embeddings."""
    return EmbeddingMetric(embeddings, metric).dists


def measure_capproximation(d_dists: torch.Tensor,
                           D_dists: torch.Tensor) -> tuple[float, float]:
    """Empirical C of Definition 2.1 after optimal rescaling of d:
    returns (scale, C) with scale·d <= D <= C·scale·d on the samples."""
    eps = 1e-9
    ratio = D_dists / torch.clamp(d_dists, min=eps)
    lo = ratio.min()
    hi = ratio.max()
    return float(lo), float(hi / torch.clamp(lo, min=eps))
