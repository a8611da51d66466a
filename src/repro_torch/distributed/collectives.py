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
  exactly, and :func:`bitmap_count` (the sum of the slices' popcounts) is
  the global popcount: the partition invariant.

The sorted dedup set is replicated like the pools, so its ops
(``ops.sorted_set_*``) need no collective at all; :func:`member_count` is
the replicated set's distinct count, the same number the partitioned bitmap
sums to.

The scatter-gather search (``core/distributed.py``) merges per-shard top-k
lists with :func:`gather_topk_merge`. :func:`allgather_matmul` and
:func:`matmul_reducescatter` are the ring matmuls: one hop of a shard (or
of a partial sum) a step, in JAX's ring order. Where JAX takes an
``axis_name``, these take the sequence of the shards.
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


def bitmap_count(scored_locals: Sequence[torch.Tensor]) -> torch.Tensor:
    """(B,) int32 global popcount of the shard-partitioned bitmap.

    The slices' row popcounts summed in shard order, on the first slice's
    device. The scatter keeps every bit on one owner (:func:`bitmap_scatter`),
    so the sum is the (B, N) bitmap's popcount: the partition invariant.
    """
    dev = scored_locals[0].device
    total = None
    for local in scored_locals:
        part = local.sum(dim=1, dtype=torch.int32).to(dev)
        total = part if total is None else total + part
    return total


def member_lookup(set_ids: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(B, K) bool: which ids the replicated sorted dedup set holds.

    ``set_ids`` (B, C) are a ``core.beam.ScoredSet``'s ascending id rows,
    replicated like the pools, so the lookup is one local ``searchsorted``
    a row with no collective (compare :func:`bitmap_lookup`)."""
    return ops.sorted_set_lookup(set_ids, ids)


def member_insert(set_ids: torch.Tensor, ids: torch.Tensor,
                  mark: torch.Tensor) -> torch.Tensor:
    """The set's (B, C) rows with the marked lanes' ids merged in. Every
    shard runs the same merge on the same replicated inputs, which keeps
    the replicas equal (the sorted set's counterpart of
    :func:`bitmap_scatter`'s owner-only writes)."""
    return ops.sorted_set_merge(
        set_ids, torch.where(mark, ids, torch.full_like(ids, ops.SET_PAD)))


def member_count(set_ids: torch.Tensor) -> torch.Tensor:
    """(B,) distinct scored ids of the replicated sorted set: the number
    :func:`bitmap_count` sums out of the partitioned bitmap (duplicate
    slots from the one-row duplicate-lane quirk collapse)."""
    return ops.sorted_set_unique_count(set_ids)


def gather_topk_merge(ids_locals: Sequence[torch.Tensor],
                      dists_locals: Sequence[torch.Tensor],
                      k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-shard top-k cut, then the gather and merge into a global top-k.

    ``ids_locals[s]`` / ``dists_locals[s]`` (B, P) are shard s's candidates
    with *global* ids (+inf padded), on its device. Each shard keeps its k
    best (``ops.local_topk``), the cuts are laid side by side shard-major
    in each row on the first shard's device (JAX's ``all_gather`` then
    ``moveaxis``) and cut again. Ties go to the lower shard; pools narrower
    than ``k`` pad with (-1, +inf). Returns (B, k) ids and dists.
    """
    dev = ids_locals[0].device
    cuts = [ops.local_topk(i, d, k) for i, d in zip(ids_locals, dists_locals)]
    all_ids = torch.cat([i.to(dev) for i, _ in cuts], dim=1)
    all_d = torch.cat([d.to(dev) for _, d in cuts], dim=1)
    return ops.local_topk(all_ids, all_d, k)


def allgather_matmul(xs: Sequence[torch.Tensor],
                     ws: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """The full ``all_gather(x) @ w`` on every shard, by a ring.

    ``xs[s]`` (m_local, k) is shard s's rows of a row-sharded M×K, ``ws[s]``
    (k, n) its copy of the weight, both on shard s's device. At step i
    shard d holds the rows of shard ``(d - i) mod S``, fills that block of
    its (m_local·S, n) output and passes the rows on to shard d + 1.
    Returns each shard's output on its device.
    """
    n_dev = len(xs)
    m_local = xs[0].shape[0]
    outs = [w.new_zeros((m_local * n_dev, w.shape[1])) for w in ws]
    chunks = list(xs)
    for i in range(n_dev):
        for d in range(n_dev):
            src = (d - i) % n_dev  # whose rows shard d holds
            block = chunks[d] @ ws[d]
            outs[d][src * m_local:(src + 1) * m_local] = block.to(
                outs[d].dtype)
        # one hop: shard d's rows move on to shard d + 1
        chunks = [chunks[(d - 1) % n_dev].to(xs[d].device)
                  for d in range(n_dev)]
    return outs


def matmul_reducescatter(xs: Sequence[torch.Tensor],
                         ws: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """The (M/S, N) row blocks of ``x @ w``, reduce-scattered by a ring.

    ``xs[s]`` (m, k_local) is shard s's columns of a column-sharded M×K and
    ``ws[s]`` (k_local, n) its rows of a row-sharded K×N. The accumulator of
    output block c starts on shard c + 1 and travels the ring, each shard
    adding its partial product of block c, so block c sums the shards in
    the order c + 1, c + 2, ..., c (mod S), as JAX's ring does. Returns
    block s on shard s's device.
    """
    n_dev = len(xs)
    m = xs[0].shape[0]
    if m % n_dev:
        raise ValueError(f"matmul_reducescatter: {m} rows do not divide "
                         f"into {n_dev} shards")
    m_local = m // n_dev

    def block(d, i):  # shard d's partial product of the block it holds
        row = ((d - i - 1) % n_dev) * m_local
        return xs[d][row:row + m_local] @ ws[d]

    dtype = torch.promote_types(xs[0].dtype, ws[0].dtype)
    accs = [torch.zeros((m_local, w.shape[1]), dtype=dtype, device=w.device)
            for w in ws]
    for i in range(n_dev - 1):
        accs = [accs[d] + block(d, i) for d in range(n_dev)]
        accs = [accs[(d - 1) % n_dev].to(ws[d].device) for d in range(n_dev)]
    return [accs[d] + block(d, n_dev - 1) for d in range(n_dev)]
