"""Scatter-gather bi-metric search over per-shard sub-indices (PyTorch).

The production layout of a large corpus, after the JAX package's
``repro.core.distributed``:

* the corpus splits into S contiguous blocks, one per device of a 1-D
  ``SearchMesh``; each block holds its own Vamana sub-index built with the
  proxy metric d only (a net of a block is a net of the union, so Theorem
  1.1 holds per shard);
* every shard runs the two-stage bi-metric search on its block at the
  per-shard quota ``max(k, Q // S)``; each cuts its answer to its k best
  and the cuts merge into the global top-k by D on the mesh's first device
  (``collectives.gather_topk_merge``). A query's D calls are the sum of the
  shards' exact counts.

One controller drives every shard, as in the rest of the port: shard s's
graph and rows live on ``mesh.devices[s]`` and its search launches the
search kernels there. JAX's mesh is 2-D (queries over ``data``, shards over
``model``); the port's has one axis and replicates the queries.

When ``quota < k·S`` the per-shard floor of k lets the total reach
``S·k > quota``: the reference does the same.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import bimetric, distances, vamana
from repro_torch.core.vamana import VamanaConfig, VamanaIndex
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import SearchMesh, search_mesh
from repro_torch.kernels import backend as kernel_backend


class ShardedIndex(NamedTuple):
    """Per-shard sub-indices; entry s of each tuple lives on shard s's
    device."""

    adjacency: tuple[torch.Tensor, ...]  # S x (n_local, R) int32, local ids
    medoid: tuple[int, ...]  # S local entry points
    emb_cheap: tuple[torch.Tensor, ...]  # S x (n_local, dim_d)
    emb_expensive: tuple[torch.Tensor, ...]  # S x (n_local, dim_D)
    config: VamanaConfig

    @property
    def n_shards(self) -> int:
        return len(self.adjacency)

    @property
    def n_local(self) -> int:
        return self.adjacency[0].shape[0]


def build_sharded(emb_cheap, emb_expensive, n_shards: int,
                  cfg: VamanaConfig | None = None, *,
                  mesh: SearchMesh | None = None,
                  device=None) -> ShardedIndex:
    """Split the corpus into contiguous blocks and build each block's graph
    with d, on its shard's device.

    ``mesh`` names each shard's device; without it every shard is on
    ``device`` (the card unless ``device="cpu"``). A shard on the corpus's
    device holds a view of its rows. The row count must be a multiple of
    ``n_shards``.
    """
    cfg = cfg or VamanaConfig()
    if mesh is None:
        mesh = search_mesh(n_shards, devices=[
            kernel_backend.resolve_device(device)] * n_shards)
    if mesh.size != n_shards:
        raise ValueError(f"{n_shards} shards on a mesh of {mesh.size}")
    # a tensor stays where it is, so that blocks on its device are views
    emb_cheap, emb_expensive = (
        x if isinstance(x, torch.Tensor)
        else kernel_backend.as_tensor(x, mesh.devices[0])
        for x in (emb_cheap, emb_expensive))
    n = emb_cheap.shape[0]
    if n % n_shards:
        raise ValueError(f"{n} rows do not divide into {n_shards} shards: "
                         "pad the corpus to a multiple of the shard count")
    if emb_expensive.shape[0] != n:
        raise ValueError(f"emb_expensive has {emb_expensive.shape[0]} rows, "
                         f"emb_cheap {n}")
    nl = n // n_shards
    adj, med, cheap, expensive = [], [], [], []
    for s, dev in enumerate(mesh.devices):
        cheap.append(emb_cheap[s * nl:(s + 1) * nl].to(dev))
        expensive.append(emb_expensive[s * nl:(s + 1) * nl].to(dev))
        idx = vamana.build(cheap[s], cfg, device=dev)
        adj.append(idx.adjacency)
        med.append(idx.medoid)
    return ShardedIndex(adjacency=tuple(adj), medoid=tuple(med),
                        emb_cheap=tuple(cheap), emb_expensive=tuple(expensive),
                        config=cfg)


def _local_search(adjacency, medoid, emb_d, emb_D, q_d, q_D, *, quota: int,
                  k: int, n_seeds: int, cfg: VamanaConfig, device):
    """Bi-metric search on one shard for the whole query batch ->
    (local ids (B, k), D dists (B, k), D calls (B,)) on ``device``.

    Both metrics score through ``l2_topk.gather_score`` (the kernel on the
    card) in gather-then-reduce form, as JAX's ``EmbeddingMetric.dists``;
    a lane's value depends on its (query, row) pair alone, so the batched
    engine is each query searched alone (JAX vmaps a one-query search).
    """
    index = VamanaIndex(adjacency=adjacency, medoid=medoid, config=cfg)
    res = bimetric.bimetric_search(
        distances.EmbeddingMetric(emb_d, cfg.metric).dists_batch,
        distances.EmbeddingMetric(emb_D, cfg.metric).dists_batch,
        index, q_d, q_D, n_points=emb_d.shape[0], quota=quota, k=k,
        n_seeds=n_seeds, device=device)
    return res.ids, res.dists, res.D_calls


def sharded_bimetric_search(mesh: SearchMesh, index: ShardedIndex, q_cheap,
                            q_expensive, *, quota: int, k: int = 10):
    """Scatter-gather bi-metric search across the mesh.

    Each shard searches its sub-index at ``max(k, quota // S)`` D calls with
    ``max(1, that // 2)`` stage-1 seeds; local ids become global (local id
    + s·n_local, -1 stays -1, invalid lanes +inf) and the shards' top-k
    merge, ties to the lower shard. Shard s's tensors must be on
    ``mesh.devices[s]``. Returns (global ids (B, k), D dists (B, k), total
    D calls (B,)) on ``mesh.devices[0]``.
    """
    s = index.n_shards
    if mesh.size != s:
        raise ValueError(f"an index of {s} shards on a mesh of {mesh.size}")
    n_local = index.n_local
    per_shard_quota = max(k, int(quota) // s)
    n_seeds = max(1, per_shard_quota // 2)
    first = mesh.devices[0]
    q_cheap = kernel_backend.as_tensor(q_cheap, first)
    q_expensive = kernel_backend.as_tensor(q_expensive, first)
    gids, gdists, calls = [], [], None
    for sh, dev in enumerate(mesh.devices):
        ids, dd, n_calls = _local_search(
            index.adjacency[sh], index.medoid[sh], index.emb_cheap[sh],
            index.emb_expensive[sh], q_cheap.to(dev), q_expensive.to(dev),
            quota=per_shard_quota, k=k, n_seeds=n_seeds, cfg=index.config,
            device=dev)
        valid = ids >= 0
        gids.append(torch.where(valid, ids + sh * n_local,
                                torch.full_like(ids, -1)))
        gdists.append(torch.where(valid, dd, torch.full_like(dd, float("inf"))))
        n_calls = n_calls.to(first)
        calls = n_calls if calls is None else calls + n_calls
    top_ids, top_dists = collectives.gather_topk_merge(gids, gdists, k)
    return top_ids, top_dists, calls
