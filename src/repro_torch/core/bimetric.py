"""The paper's contribution: bi-metric two-stage search (§4), DiskANN form.

Given a graph built only with the cheap metric d (``vamana.build``):

  stage 1 — greedy search with d; zero D calls; keeps the top-K seeds
            (paper default K = Q/2);
  stage 2 — greedy search on the same graph with the expensive metric D
            from the seeds; every D evaluation (seeds included) counts
            against the quota Q and no pair is ever paid for twice.

Both stages run the batched engine (``repro_torch.core.beam``). The metric
callables are batched: ``fn(q (B, dim), ids (B, K)) -> (B, K)``, e.g.
``EmbeddingMetric.dists_batch``. Also the re-rank baseline
(:func:`rerank_search`): top-Q by d, score all with D.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from repro_torch.core.beam import (NO_QUOTA, batched_greedy_search,
                                   fused_dist_fn, sharded_greedy_search)
from repro_torch.core.vamana import VamanaIndex
from repro_torch.kernels import backend as kernel_backend

BatchFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
_I32 = torch.int32


class BiMetricResult(NamedTuple):
    ids: torch.Tensor  # (B, k) best by D
    dists: torch.Tensor  # (B, k) D-distances
    d_calls: torch.Tensor  # (B,) cheap-metric calls (stage 1)
    D_calls: torch.Tensor  # (B,) expensive-metric calls — the paper's cost


def _medoid_entries(index: VamanaIndex, batch: int, device) -> torch.Tensor:
    """(B, 1) entry matrix — every query starts at the graph medoid."""
    return torch.full((batch, 1), int(index.medoid), dtype=_I32,
                      device=device)


def _on_device(index: VamanaIndex, dev) -> VamanaIndex:
    return index._replace(
        adjacency=kernel_backend.as_tensor(index.adjacency, dev, _I32))


def _stage1_batch(cheap_fn_batch: BatchFn, index: VamanaIndex, q_cheap, *,
                  n_points: int, n_seeds: int, l_search: int,
                  expand_width: int = 1):
    """Cheap-metric greedy search -> (seeds (B, n_seeds), d_calls (B,))."""
    res = batched_greedy_search(
        cheap_fn_batch, index.adjacency, q_cheap,
        _medoid_entries(index, q_cheap.shape[0], q_cheap.device),
        n_points=n_points, beam_width=l_search,
        pool_size=max(l_search, n_seeds), quota=NO_QUOTA,
        expand_width=expand_width, max_steps=4 * l_search)
    return res.pool_ids[:, :n_seeds].contiguous(), res.n_calls


def _quota_arg(quota, dev):
    """(python int or (B,) int32 tensor on ``dev``, is_scalar)."""
    if isinstance(quota, torch.Tensor) and quota.ndim > 0:
        return quota.to(device=dev, dtype=_I32), False
    if not isinstance(quota, torch.Tensor) and getattr(quota, "ndim", 0) > 0:
        return kernel_backend.as_tensor(quota, dev, _I32), False
    return int(quota), True


def bimetric_search(
    cheap_fn_batch: BatchFn | None,
    expensive_fn_batch: BatchFn | None,
    index: VamanaIndex,
    q_cheap,
    q_expensive,
    *,
    n_points: int,
    quota,
    k: int = 10,
    n_seeds: int | None = None,
    l_search_d: int | None = None,
    beam_width_D: int | None = None,
    use_stage1: bool = True,
    expand_width: int = 1,
    shards: int = 1,
    corpora=None,
    mesh=None,
    metric: str = "l2",
    backend=None,
    quantize=None,
    device=None,
) -> BiMetricResult:
    """Batched bi-metric search (the DiskANN instantiation).

    ``quota`` may be a (B,) vector (then ``n_seeds`` and ``beam_width_D``
    are required); each query freezes at its own budget. With
    ``corpora=(corpus_d, corpus_D)`` (tensors or prebuilt ``CorpusView``
    objects) the matmul backend, ``quantize=`` or a view score a stage over
    its corpus through ``ops.gather_score``; ``quantize`` applies to stage 1
    only — the ground-truth stage is never quantized by this knob.

    ``shards > 1`` runs both stages over corpora split into ``shards``
    blocks on ``mesh`` (``beam.sharded_greedy_search``); the metrics must
    then be embedding-backed: pass ``corpora`` (the callables are ignored).
    The result is bit-exact against ``shards=1``.
    """
    if not isinstance(index, VamanaIndex):
        raise NotImplementedError(
            "bimetric_search over a cover tree waits for the port's "
            "cover-tree slice; pass a VamanaIndex")
    if shards > 1 and corpora is None:
        raise ValueError("shards > 1 needs corpora=(corpus_d, corpus_D): "
                         "only embedding-backed metrics can be sharded")
    dev = kernel_backend.resolve_device(device)
    be1 = kernel_backend.resolve_backend(backend, quantize=quantize,
                                         _caller="bimetric_search")
    be = dataclasses.replace(be1, quantize=None)  # stage 2: never quantized

    def _fused(corpus, bb):
        return (bb.matmul or bb.quantize is not None
                or isinstance(corpus, kernel_backend.CorpusView))

    def _corpus(c):
        return (c if isinstance(c, kernel_backend.CorpusView)
                else kernel_backend.as_tensor(c, dev))

    use_fused1 = corpora is not None and _fused(corpora[0], be1)
    use_fused = corpora is not None and _fused(corpora[1], be)
    index = _on_device(index, dev)
    q_cheap = kernel_backend.as_tensor(q_cheap, dev)
    q_expensive = kernel_backend.as_tensor(q_expensive, dev)
    b = q_cheap.shape[0]
    quota, scalar_quota = _quota_arg(quota, dev)
    if n_seeds is None:
        if not scalar_quota:
            raise ValueError("a per-query (B,) quota needs an explicit n_seeds")
        n_seeds = max(1, quota // 2)  # paper default: top-Q/2
    l1 = l_search_d or max(index.config.l_build, n_seeds)

    if use_stage1 and shards > 1:
        res1 = sharded_greedy_search(
            _corpus(corpora[0]), index.adjacency, q_cheap,
            _medoid_entries(index, b, dev), shards=shards, metric=metric,
            mesh=mesh, beam_width=l1, pool_size=max(l1, n_seeds),
            quota=NO_QUOTA, expand_width=expand_width, max_steps=4 * l1,
            backend=be1, device=dev)
        seeds, d_calls = res1.pool_ids[:, :n_seeds].contiguous(), res1.n_calls
    elif use_stage1:
        seeds, d_calls = _stage1_batch(
            (fused_dist_fn(_corpus(corpora[0]), metric, backend=be1)
             if use_fused1 else cheap_fn_batch),
            index, q_cheap, n_points=n_points, n_seeds=n_seeds, l_search=l1,
            expand_width=expand_width)
    else:  # "Default" ablation: start from the graph entry point only
        seeds = torch.full((b, max(n_seeds, 1)), -1, dtype=_I32, device=dev)
        seeds[:, 0] = int(index.medoid)
        d_calls = torch.zeros((b,), dtype=_I32, device=dev)

    if beam_width_D is None:
        if not scalar_quota:
            raise ValueError(
                "a per-query (B,) quota needs an explicit beam_width_D")
        bw = max(k, min(quota, 2 * n_seeds + 8))
    else:
        bw = beam_width_D
    # the quota is the real stop; steps = per-query safety cap
    max_steps_D = min(4 * quota, NO_QUOTA) if scalar_quota else 4 * quota
    if shards > 1:
        res = sharded_greedy_search(
            _corpus(corpora[1]), index.adjacency, q_expensive, seeds,
            shards=shards, metric=metric, mesh=mesh, beam_width=bw,
            pool_size=max(bw, k), quota=quota, expand_width=expand_width,
            max_steps=max_steps_D, backend=be, device=dev)
        return BiMetricResult(ids=res.pool_ids[:, :k],
                              dists=res.pool_dists[:, :k], d_calls=d_calls,
                              D_calls=res.n_calls)
    res = batched_greedy_search(
        (fused_dist_fn(_corpus(corpora[1]), metric, backend=be)
         if use_fused else expensive_fn_batch),
        index.adjacency, q_expensive, seeds, n_points=n_points,
        beam_width=bw, pool_size=max(bw, k), quota=quota,
        expand_width=expand_width, max_steps=max_steps_D)
    return BiMetricResult(ids=res.pool_ids[:, :k], dists=res.pool_dists[:, :k],
                          d_calls=d_calls, D_calls=res.n_calls)


def bimetric_search_single(cheap_fn, expensive_fn, index: VamanaIndex, *,
                           n_points: int, quota: int, k: int = 10,
                           n_seeds: int | None = None,
                           l_search_d: int | None = None,
                           beam_width_D: int | None = None,
                           use_stage1: bool = True, device=None):
    """One query (B = 1 through the batched engine).

    ``cheap_fn`` / ``expensive_fn`` close over the query: (k,) ids -> (k,).
    Returns (ids (k,), D_dists (k,), d_calls, D_calls).
    """
    dev = kernel_backend.resolve_device(device)
    zeros = torch.zeros((1, 1), device=dev)
    res = bimetric_search(
        lambda _q, ids: cheap_fn(ids[0])[None],
        lambda _q, ids: expensive_fn(ids[0])[None],
        index, zeros, zeros, n_points=n_points, quota=quota, k=k,
        n_seeds=n_seeds, l_search_d=l_search_d, beam_width_D=beam_width_D,
        use_stage1=use_stage1, device=dev)
    return res.ids[0], res.dists[0], res.d_calls[0], res.D_calls[0]


def rerank_search(cheap_fn_batch: BatchFn, expensive_fn_batch: BatchFn,
                  index: VamanaIndex, q_cheap, q_expensive, *, n_points: int,
                  quota: int, k: int = 10, l_search_d: int | None = None,
                  expand_width: int = 1, device=None) -> BiMetricResult:
    """"Bi-metric (baseline)": retrieve top-``quota`` by d, re-rank by D.

    Exactly ``quota`` D calls per query (the re-ranking scan).
    """
    dev = kernel_backend.resolve_device(device)
    index = _on_device(index, dev)
    q_cheap = kernel_backend.as_tensor(q_cheap, dev)
    q_expensive = kernel_backend.as_tensor(q_expensive, dev)
    l1 = l_search_d or max(index.config.l_build, quota)
    cand, d_calls = _stage1_batch(
        cheap_fn_batch, index, q_cheap, n_points=n_points, n_seeds=quota,
        l_search=max(l1, quota), expand_width=expand_width)
    dd = expensive_fn_batch(q_expensive, cand)
    dd = torch.where(cand >= 0, dd, torch.full_like(dd, float("inf")))
    order = torch.argsort(dd, dim=1, stable=True)[:, :k]
    n_D = (cand >= 0).sum(dim=1, dtype=_I32)
    return BiMetricResult(ids=cand.gather(1, order), dists=dd.gather(1, order),
                          d_calls=d_calls, D_calls=n_D)
