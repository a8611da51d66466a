"""Synthetic bi-metric corpora with controllable C-approximation (PyTorch).

The construction of the JAX package's ``repro.data.synthetic``, drawn from a
``torch.Generator`` on the target device (the bits differ from JAX's):

* the ground-truth embedding ``E_D`` is a clustered Gaussian mixture (dim_D);
* the proxy ``E_d`` is a random JL projection of coarse structure plus
  attenuated local detail (``local_visibility``) to dim_d, with bounded
  multiplicative noise, and optional additive noise on the proxy *queries*
  only (``query_noise``) — the failure mode of small embedding models.

The token batches for the training drivers (``make_lm_tokens``,
``make_contrastive_pairs``) are drawn with NumPy, as JAX's are, so each
array is byte for byte the JAX package's for each seed.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import distances
from repro_torch.kernels.backend import resolve_device


class BiMetricData(NamedTuple):
    corpus_D: torch.Tensor  # (N, dim_D) ground-truth embeddings
    corpus_d: torch.Tensor  # (N, dim_d) proxy embeddings
    queries_D: torch.Tensor  # (B, dim_D)
    queries_d: torch.Tensor  # (B, dim_d)
    c_estimate: float  # empirical C on sampled pairs


def make_dataset(*, n: int = 4096, n_queries: int = 64, dim_D: int = 128,
                 dim_d: int = 16, n_clusters: int = 64, noise: float = 0.05,
                 local_visibility: float = 1.0, query_noise: float = 0.0,
                 seed: int = 0, device=None) -> BiMetricData:
    """Generate a (corpus, queries) pair under D and d on ``device``."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    centers = randn(n_clusters, dim_D) * 4.0
    assign = torch.randint(0, n_clusters, (n,), generator=g, device=dev)
    local = randn(n, dim_D)
    corpus_D = centers[assign] + local

    # queries live near corpus structure (perturbed corpus points)
    qidx = torch.randint(0, n, (n_queries,), generator=g, device=dev)
    q_noise = 0.5 * randn(n_queries, dim_D)
    queries_D = corpus_D[qidx] + q_noise

    # proxy = coarse structure + attenuated local detail, JL-projected, with
    # multiplicative noise (bounded distortion -> a C-approximation)
    lv = local_visibility
    proj = randn(dim_D, dim_d) / math.sqrt(dim_d)
    local_scale = torch.std(local[:256] @ proj, correction=0)
    proxy_query_in = centers[assign[qidx]] + lv * (local[qidx] + q_noise)
    local.mul_(lv).add_(centers[assign])  # in place: the proxy corpus input
    corpus_d = local @ proj
    del local
    queries_d = proxy_query_in @ proj
    corpus_d = corpus_d * (1.0 + noise * randn(*corpus_d.shape))
    queries_d = queries_d * (1.0 + noise * randn(*queries_d.shape))
    if query_noise:
        # additive noise at the scale of projected local structure
        queries_d = queries_d + query_noise * local_scale * randn(
            *queries_d.shape)

    m = min(n, 512)
    dd = distances.pairwise(queries_d, corpus_d[:m])
    dD = distances.pairwise(queries_D, corpus_D[:m])
    _, c = distances.measure_capproximation(dd.reshape(-1), dD.reshape(-1))
    return BiMetricData(corpus_D=corpus_D, corpus_d=corpus_d,
                        queries_D=queries_D, queries_d=queries_d,
                        c_estimate=float(c))


def proxy_quality_sweep(quality: str) -> dict:
    """Map a named proxy quality tier to (dim_d, noise, local_visibility,
    query_noise) — the Table 1 analogue."""
    return {
        "bge-micro-like": dict(dim_d=8, noise=0.10, local_visibility=0.25,
                               query_noise=2.0),
        "gte-small-like": dict(dim_d=16, noise=0.06, local_visibility=0.5,
                               query_noise=1.0),
        "bge-base-like": dict(dim_d=48, noise=0.02, local_visibility=0.85,
                              query_noise=0.25),
    }[quality]


def make_lm_tokens(*, batch: int, seq_len: int, vocab: int,
                   seed: int = 0) -> dict[str, np.ndarray]:
    """Synthetic LM batch (tokens + shifted labels) for training drivers."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, size=(batch, seq_len + 1), dtype=np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def make_contrastive_pairs(*, batch: int, seq_len: int, vocab: int,
                           seed: int = 0) -> dict[str, np.ndarray]:
    """(query, positive-doc) token pairs for bi-encoder InfoNCE training.

    Positives share a prefix with the query (synthetic relevance signal).
    """
    rng = np.random.default_rng(seed)
    q = rng.integers(0, vocab, size=(batch, seq_len), dtype=np.int32)
    d = q.copy()
    tail = seq_len // 2
    d[:, tail:] = rng.integers(0, vocab, size=(batch, seq_len - tail),
                               dtype=np.int32)
    return {"query_tokens": q, "doc_tokens": d}
