"""Batched Vamana (DiskANN) graph construction and search (PyTorch).

Synchronous rounds, as in the JAX package: every round beam-searches all
points against the current graph (one batched-engine run per chunk of
``build_batch`` points), robust-prunes each candidate pool, then folds in
reverse edges and prunes again. Only the proxy metric over ``x`` is ever
evaluated (Theorem 1.1, property 1).

``build`` takes an optional ``init_adjacency``: torch cannot reproduce the
JAX package's ``jax.random`` draw of the initial graph, so a caller that
needs both packages on one graph hands the draw in.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import distances
from repro_torch.core.beam import batched_greedy_search
from repro_torch.core.beam import fused_dist_fn as beam_fused_dist_fn
from repro_torch.core.beam import sharded_greedy_search
from repro_torch.kernels import backend as kernel_backend

_I32 = torch.int32


class VamanaConfig(NamedTuple):
    max_degree: int = 64  # R
    l_build: int = 125  # beam width during construction
    alpha: float = 1.2  # shortcut-reachability slack (paper: alpha >= 1)
    n_rounds: int = 2  # pass 1 at alpha=1.0, pass 2..n at alpha
    pool_size: int = 256  # candidate pool fed to robust prune
    rev_candidates: int = 64  # reverse-edge candidates folded per node
    build_batch: int = 1024  # points processed per chunk
    metric: str = "l2"
    seed: int = 0


class VamanaIndex(NamedTuple):
    adjacency: torch.Tensor  # (N, R) int32, -1 padded
    medoid: int
    config: VamanaConfig


def find_medoid(x: torch.Tensor, metric: str = "l2") -> int:
    """Vertex closest to the centroid — the canonical DiskANN entry point."""
    centroid = x.float().mean(dim=0, keepdim=True)
    d = distances.pairwise(centroid, x, metric)[0]
    return int(torch.argmin(d).item())


def robust_prune(p_ids: torch.Tensor, pool_ids: torch.Tensor,
                 pool_dists: torch.Tensor, x: torch.Tensor, *, alpha: float,
                 max_degree: int, metric: str) -> torch.Tensor:
    """DiskANN RobustPrune for a batch of vertices -> (B, R) int32.

    ``p_ids`` (B,), pools (B, P) sorted ascending. Keeps <= R out-neighbors
    such that every pruned candidate j has a kept neighbor c with
    alpha·d(c, j) <= d(p, j) (Definition 3.1 restricted to the pool).
    """
    b, P = pool_ids.shape
    dev = pool_ids.device
    valid = ((pool_ids >= 0) & (pool_ids != p_ids[:, None])
             & torch.isfinite(pool_dists))
    rows = x[pool_ids.clamp(min=0).long()]
    pd = distances.pairwise(rows, rows, metric)  # (B, P, P)
    ar = torch.arange(P, device=dev)
    sel = torch.full((b, max_degree + 1), -1, dtype=_I32, device=dev)
    n_sel = torch.zeros((b,), dtype=torch.long, device=dev)
    pruned = torch.zeros((b, P), dtype=torch.bool, device=dev)
    for t in range(P):
        ok = valid[:, t] & ~pruned[:, t] & (n_sel < max_degree)
        occl = (alpha * pd[:, t, :] <= pool_dists) & (ar > t)
        pruned |= occl & ok[:, None]
        # a spare column takes the writes of rows that keep nothing here
        slot = torch.where(ok, n_sel, max_degree)
        sel.scatter_(1, slot[:, None], pool_ids[:, t:t + 1])
        n_sel += ok.long()
    return sel[:, :max_degree]


def _search_pool(x, adjacency, medoid, ids, cfg: VamanaConfig):
    """Beam-search a chunk of point ids against the current graph."""
    em = distances.EmbeddingMetric(x, cfg.metric)
    b = ids.shape[0]
    entries = torch.full((b, 1), medoid, dtype=_I32, device=x.device)
    res = batched_greedy_search(
        em.dists_batch, adjacency, x[ids.long()], entries,
        n_points=x.shape[0], beam_width=cfg.l_build,
        pool_size=cfg.pool_size, max_steps=2 * cfg.l_build)
    return res.pool_ids, res.pool_dists


def _reverse_candidates(adjacency: torch.Tensor, k_rev: int) -> torch.Tensor:
    """(N, k_rev) int32: for each node, up to k_rev vertices that point at it."""
    n, r = adjacency.shape
    dev = adjacency.device
    src = torch.arange(n, dtype=_I32, device=dev).repeat_interleave(r)
    dst = adjacency.reshape(-1).to(_I32)
    order = torch.argsort(dst, stable=True)  # invalid (-1) sort first
    dst_s, src_s = dst[order], src[order]
    nodes = torch.arange(n, dtype=_I32, device=dev)
    starts = torch.searchsorted(dst_s, nodes)
    counts = torch.searchsorted(dst_s, nodes, right=True) - starts
    take = torch.clamp(counts, max=k_rev)
    kr = torch.arange(k_rev, device=dev)
    idx = (starts[:, None] + kr[None, :]).clamp(0, n * r - 1)
    ok = kr[None, :] < take[:, None]
    return torch.where(ok, src_s[idx], torch.full_like(idx, -1, dtype=_I32))


def _augment_and_prune(x, adjacency, *, alpha, cfg: VamanaConfig):
    """Fold reverse edges into each node's list and robust-prune the union."""
    n = x.shape[0]
    rev = _reverse_candidates(adjacency, cfg.rev_candidates)
    em = distances.EmbeddingMetric(x, cfg.metric)
    ids = torch.arange(n, dtype=_I32, device=x.device)
    out = []
    for s in range(0, n, cfg.build_batch):
        sl = slice(s, min(s + cfg.build_batch, n))
        i = ids[sl]
        cand = torch.cat([adjacency[sl], rev[sl]], dim=1)
        w = cand.shape[1]
        ar = torch.arange(w, device=x.device)
        dup = ((cand[:, :, None] == cand[:, None, :])
               & (ar[:, None] > ar[None, :]))
        cand = torch.where(dup.any(dim=2) | (cand == i[:, None]),
                           torch.full_like(cand, -1), cand)
        d = em.dists_batch(x[sl], cand)
        order = torch.argsort(d, dim=1, stable=True)
        out.append(robust_prune(
            i, cand.gather(1, order), d.gather(1, order), x, alpha=alpha,
            max_degree=cfg.max_degree, metric=cfg.metric))
    return torch.cat(out, dim=0)


def build(x, cfg: VamanaConfig | None = None, *, init_adjacency=None,
          device=None) -> VamanaIndex:
    """Construct a Vamana graph over corpus embeddings ``x`` (N, dim).

    ``init_adjacency`` (N, R) is the initial random graph; without it one is
    drawn from a ``torch.Generator`` seeded with ``cfg.seed`` (self-loops
    knocked out), which differs from the JAX package's draw.
    """
    if cfg is None:
        cfg = VamanaConfig()
    dev = kernel_backend.resolve_device(device)
    x = kernel_backend.as_tensor(x, dev)
    n = x.shape[0]
    r = cfg.max_degree
    if init_adjacency is None:
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)
        init = torch.randint(0, n, (n, r), generator=gen, device=dev,
                             dtype=_I32)
        self_ = torch.arange(n, dtype=_I32, device=dev)[:, None]
        init = torch.where(init == self_, torch.full_like(init, -1), init)
    else:
        init = kernel_backend.as_tensor(init_adjacency, dev, _I32)
        if tuple(init.shape) != (n, r):
            raise ValueError(f"init_adjacency must be {(n, r)}, got "
                             f"{tuple(init.shape)}")
    adjacency = init
    medoid = find_medoid(x, cfg.metric)
    ids = torch.arange(n, dtype=_I32, device=dev)

    for rnd in range(cfg.n_rounds):
        alpha = 1.0 if rnd < cfg.n_rounds - 1 else cfg.alpha
        new_rows = []
        for s in range(0, n, cfg.build_batch):
            chunk = ids[s:min(s + cfg.build_batch, n)]
            pool_ids, pool_dists = _search_pool(x, adjacency, medoid, chunk,
                                                cfg)
            new_rows.append(robust_prune(
                chunk, pool_ids, pool_dists, x, alpha=alpha,
                max_degree=cfg.max_degree, metric=cfg.metric))
        adjacency = torch.cat(new_rows, dim=0)
        adjacency = _augment_and_prune(x, adjacency, alpha=alpha, cfg=cfg)

    return VamanaIndex(adjacency=adjacency, medoid=medoid, config=cfg)


def search(index: VamanaIndex, corpus_emb, query_emb, *, k: int,
           beam_width: int | None = None, quota=None,
           metric: str | None = None, n_entries: int = 8,
           expand_width: int = 1, shards: int = 1, mesh=None, backend=None,
           quantize=None, device=None):
    """Single-metric search -> (ids (B, k), dists (B, k), calls (B,)).

    Starts from the medoid plus ``n_entries - 1`` stratified vertices.
    ``quota`` may be a (B,) vector. ``corpus_emb`` may be a prebuilt
    ``CorpusView``; ``backend="matmul"`` or ``quantize=`` score over a view.
    ``shards > 1`` runs the same loop over a corpus split into ``shards``
    blocks on ``mesh`` (``beam.sharded_greedy_search``), bit-exact against
    ``shards=1``.
    """
    dev = kernel_backend.resolve_device(device)
    met = metric or index.config.metric
    L = beam_width or max(k, index.config.l_build)
    if isinstance(corpus_emb, kernel_backend.CorpusView):
        n = corpus_emb.n
    else:
        corpus_emb = kernel_backend.as_tensor(corpus_emb, dev)
        n = corpus_emb.shape[0]
    query_emb = kernel_backend.as_tensor(query_emb, dev)
    adjacency = kernel_backend.as_tensor(index.adjacency, dev, _I32)
    b = query_emb.shape[0]
    stride = max(1, n // max(n_entries, 1))
    entries = torch.cat([
        torch.tensor([int(index.medoid)], dtype=_I32),
        (torch.arange(max(n_entries - 1, 0), dtype=_I32) * stride) % n,
    ]).to(dev)
    entries_b = entries[None, :].expand(b, -1).contiguous()
    if quota is None:
        quota = torch.iinfo(torch.int32).max // 2
    elif isinstance(quota, torch.Tensor) and quota.ndim == 1:
        quota = quota.to(dev)
    else:
        quota = int(quota)
    be = kernel_backend.resolve_backend(backend, quantize=quantize,
                                        _caller="vamana.search")
    if shards > 1:
        res = sharded_greedy_search(
            corpus_emb, adjacency, query_emb, entries_b, shards=shards,
            metric=met, mesh=mesh, beam_width=L, pool_size=max(L, k),
            quota=quota, expand_width=expand_width, max_steps=4 * L,
            backend=be, device=dev)
        return res.pool_ids[:, :k], res.pool_dists[:, :k], res.n_calls
    if (be.matmul or be.quantize is not None
            or isinstance(corpus_emb, kernel_backend.CorpusView)):
        dist_fn = beam_fused_dist_fn(corpus_emb, met, backend=be)
    else:
        dist_fn = distances.EmbeddingMetric(corpus_emb, met).dists_batch
    res = batched_greedy_search(
        dist_fn, adjacency, query_emb, entries_b, n_points=n, beam_width=L,
        pool_size=max(L, k), quota=quota, expand_width=expand_width,
        max_steps=4 * L)
    return res.pool_ids[:, :k], res.pool_dists[:, :k], res.n_calls
