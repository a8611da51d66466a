"""The wave collectives of the sharded beam engine.

One controller drives every shard, as ``shard_map`` does in the JAX package:
the replicated search state (pools, ``expanded``, counters, a sorted
``ScoredSet``) lives once, on the mesh's first device, and only the corpus
blocks and the bitmap's column slices live per shard. Shard s owns global
rows ``[s * n_local, (s + 1) * n_local)`` and the matching columns of every
query's scored bitmap. A collective loops over the shards in shard order and
combines their answers on the device of the replicated input.

* :func:`wave_gather_score`: each shard scores the lanes it owns with the
  shard-local kernel (foreign and padding lanes give 0.0) and the partials
  are summed in shard order. The sum is the unsharded wave bit for bit: each
  id has one owner and x + 0.0 == x. An ``ip`` lane of -0.0 comes out +0.0.
* :func:`bitmap_lookup` / :func:`bitmap_scatter`: membership ORs the
  owners' answers, a scatter lands on the owner's slice only (in place).
  Every bit has one owner, so the slices partition the (B, N) bitmap
  exactly.

The sorted dedup set is replicated like the pools, so its ops
(``ops.sorted_set_*``) need no collective at all.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.backend import corpus_rows


def shard_offset(shard: int, n_local: int) -> int:
    """First global corpus row owned by ``shard`` (contiguous placement)."""
    return shard * n_local


def wave_gather_score(corpus_locals: Sequence, queries: torch.Tensor,
                      ids: torch.Tensor, *, metric: str = "sqeuclidean",
                      backend=None) -> torch.Tensor:
    """The sharded gather→score of one wave -> (B, K) on ``ids``' device.

    ``corpus_locals[s]`` is shard s's block, raw (n_local, dim) rows or its
    ``CorpusView``, on that shard's device; ``queries`` (B, dim) and ``ids``
    (B, K) global are the replicated wave. Equals the unsharded
    ``ops.gather_score`` under the same backend and residency (ids < 0 ->
    +inf).
    """
    d = None
    for s, local in enumerate(corpus_locals):
        rows = corpus_rows(local)
        part = ops.gather_score_local(
            local, queries.to(rows.device), ids.to(rows.device),
            shard_offset(s, rows.shape[0]), metric=metric, backend=backend)
        part = part.to(ids.device)
        d = part if d is None else d + part
    return torch.where(ids >= 0, d, torch.full_like(d, float("inf")))


def _owned(ids: torch.Tensor, shard: int, n_local: int):
    """(local column (clamped into the slice), owned (B, K) bool)."""
    loc = ids - shard_offset(shard, n_local)
    owned = (ids >= 0) & (loc >= 0) & (loc < n_local)
    return loc.clamp(0, n_local - 1).long(), owned


def bitmap_lookup(scored_locals: Sequence[torch.Tensor],
                  ids: torch.Tensor) -> torch.Tensor:
    """(B, K) bool: the owners' answers for global ``ids``, ORed.

    ``scored_locals[s]`` (B, n_local) is shard s's column slice of the
    (B, N) scored bitmap. Lanes with id < 0 give False.
    """
    hit = torch.zeros(ids.shape, dtype=torch.bool, device=ids.device)
    for s, local in enumerate(scored_locals):
        col, owned = _owned(ids.to(local.device), s, local.shape[1])
        hit |= (local.gather(1, col) & owned).to(ids.device)
    return hit


def bitmap_scatter(scored_locals: Sequence[torch.Tensor], ids: torch.Tensor,
                   mark: torch.Tensor):
    """Set the marked lanes' bits on their owners' slices, in place.

    Foreign lanes are masked on every slice, so no bit is set twice or
    lost. The update is a scatter-OR (``amax`` on the uint8 view): masked
    lanes all alias one column, and a plain indexed store would race on the
    card. Returns ``scored_locals``.
    """
    for s, local in enumerate(scored_locals):
        col, owned = _owned(ids.to(local.device), s, local.shape[1])
        owned &= mark.to(local.device)
        local.view(torch.uint8).scatter_reduce_(1, col, owned.to(torch.uint8),
                                                reduce="amax")
    return scored_locals

