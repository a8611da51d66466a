"""Batched greedy graph search (paper Algorithm 1) — the one shared hot loop.

Every search — index construction (d), stage 1 (d), stage 2 (D) and the
re-rank baseline — runs this engine. One step advances a whole batch of B
queries: pick up to ``expand_width`` best unexpanded vertices in each
query's beam prefix, gather their (B, E, R) fanout, drop vertices already
scored (per-query dedup state), mask to the per-query quota, score the
survivors with one batched distance call and merge (pool ‖ fanout) back
with the stable merge kernel (``ops.merge_pool_batch``).

Dedup backends, bit-exact to each other:

* ``bitmap`` — a dense (B, N) bool bitmap. The scatter is a scatter-OR
  (``scatter_reduce`` amax on its uint8 view), since padding lanes alias
  column 0 and a plain indexed store would race on the card;
* ``sorted`` — a :class:`ScoredSet` of per-query ascending id rows of static
  capacity C = quota (lookup by ``searchsorted``, insertion by sort).

``lax.while_loop`` becomes a host loop that reads ``active.any()`` back only
every :data:`CHECK_EVERY` steps. That is exact: a frozen row plans an
all-masked wave, the stable merge leaves its pool unchanged, and
``n_steps`` counts only active rows.

The serving slot pool recycles rows of one resident state with
:func:`reset_slots`, grows its static shapes with :func:`grow_state` (an
exact no-op) and freezes a row it resolved early with
:func:`early_resolve`; rows outside their masks pass through bit for bit.

Unlike the JAX package's pure functions, :func:`plan_step` updates the
dedup state in place (a (B, N) bitmap copy per step would dominate the
build); a state must not be used again after it is passed to
:func:`plan_step`.

Sharded search (:func:`sharded_greedy_search`): the corpus is split into
contiguous row blocks over a 1-D mesh (``repro_torch.distributed``) and one
controller drives every shard. The replicated state (pools, counters, a
sorted set) lives on the mesh's first device, so the merge runs once per
step; under a :class:`ShardCtx` the bitmap is a tuple of per-shard column
slices, and waves are scored by the shard-local kernel, one launch per
shard, summed in shard order. Results are bit-exact against the
single-device engine under the same backend.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import (search_mesh, shard_corpus,
                                              shard_corpus_view)
from repro_torch.kernels import backend as kernel_backend
from repro_torch.kernels import ops

NO_QUOTA = torch.iinfo(torch.int32).max // 2

#: host-loop steps between two reads of ``active.any()``
CHECK_EVERY = 8

_I32 = torch.int32


class ShardCtx(NamedTuple):
    """Handle for running the engine over a corpus mesh.

    ``devices`` holds the device of each shard, in shard order; shard s
    owns global rows ``[s * n_local, (s + 1) * n_local)``. Under a ShardCtx
    the bitmap form of ``BatchedSearchState.scored`` is the tuple of the S
    (B, n_local) column slices, each on its shard's device; everything else
    in the state is replicated, once, on ``devices[0]``.
    """

    devices: tuple[torch.device, ...]
    n_local: int


class ScoredSet(NamedTuple):
    """Quota-proportional dedup state: per-query sorted membership arrays.

    ``ids`` (B, C) int32 ascending, ``ops.SET_PAD`` padded; ``count`` (B,)
    insertions so far (the overflow diagnostic: ``count <= capacity``).
    Under a :class:`ShardCtx` the set is replicated like the pools.
    """

    ids: torch.Tensor
    count: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.ids.shape[1]


def empty_scored_set(batch: int, capacity: int,
                     device: torch.device | str = "cpu") -> ScoredSet:
    return ScoredSet(
        ids=torch.full((batch, capacity), ops.SET_PAD, dtype=_I32,
                       device=device),
        count=torch.zeros((batch,), dtype=_I32, device=device),
    )


class BatchedSearchState(NamedTuple):
    """Per-query search state, batch-leading."""

    pool_ids: torch.Tensor  # (B, P) int32, sorted by dist; -1 pad
    pool_dists: torch.Tensor  # (B, P) f32; +inf pad
    expanded: torch.Tensor  # (B, P) bool
    scored: torch.Tensor | ScoredSet | tuple  # dedup state (see ShardCtx)
    n_calls: torch.Tensor  # (B,) int32
    n_steps: torch.Tensor  # (B,) int32


class SearchResult(NamedTuple):
    pool_ids: torch.Tensor
    pool_dists: torch.Tensor
    scored: torch.Tensor
    n_calls: torch.Tensor
    n_steps: torch.Tensor


def _positional_dedup(ids: torch.Tensor) -> torch.Tensor:
    """Per row: an id equal to an earlier id in the row becomes -1."""
    e = ids.shape[-1]
    ar = torch.arange(e, device=ids.device)
    dup = (ids[..., :, None] == ids[..., None, :]) & (ar[:, None] > ar[None, :])
    return torch.where(dup.any(dim=-1), torch.full_like(ids, -1), ids)


def _static_quota_bound(quota) -> int:
    """max(quota) as a Python int (a tensor is read back once)."""
    if isinstance(quota, torch.Tensor):
        return int(quota.max().item())
    return int(np.max(np.asarray(quota)))


def _per_query(v, b: int, device) -> torch.Tensor:
    """Broadcast a scalar-or-(B,) knob to a (B,) int32 vector."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=_I32).expand(b).contiguous()
    return torch.as_tensor(np.asarray(v), dtype=_I32).to(device).expand(
        b).contiguous()


def resolve_dedup(dedup: str, set_capacity: int | None, quota, n_points: int,
                  scored_init=None, *, drive: str = "host"):
    """Pick the dedup backend -> ``("bitmap", None) | ("sorted", capacity)``.

    ``"auto"`` picks ``sorted`` when the quota bound is smaller than the
    corpus under a host-stepped drive; the fused drive (one
    :func:`batched_greedy_search`) keeps the bitmap on auto, as the JAX
    package does. Explicit backends are honored.
    """
    if dedup == "bitmap":
        return "bitmap", None
    if dedup == "auto" and drive == "fused" and not isinstance(
            scored_init, ScoredSet):
        return "bitmap", None
    if scored_init is not None and not isinstance(scored_init, ScoredSet):
        if dedup == "sorted":
            raise ValueError(
                "dedup='sorted' cannot continue a bitmap scored_init")
        return "bitmap", None
    if isinstance(scored_init, ScoredSet):
        return "sorted", scored_init.capacity
    if dedup not in ("sorted", "auto"):
        raise ValueError(f"unknown dedup backend {dedup!r}")
    qmax = _static_quota_bound(quota)
    if set_capacity is None:
        set_capacity = qmax
    elif qmax <= NO_QUOTA // 2 and set_capacity < qmax:
        raise ValueError(f"set_capacity={set_capacity} < quota bound {qmax}")
    set_capacity = max(int(set_capacity), 0)
    if dedup == "auto" and set_capacity >= n_points:
        return "bitmap", None
    return "sorted", set_capacity


def _bitmap_or(bitmap: torch.Tensor, cols: torch.Tensor,
               mark: torch.Tensor) -> torch.Tensor:
    """In place: bitmap[b, cols[b, j]] |= mark[b, j] (a race-free OR)."""
    bitmap.view(torch.uint8).scatter_reduce_(
        1, cols.long(), mark.to(torch.uint8), reduce="amax")
    return bitmap


def scored_set_to_bitmap(sset: ScoredSet, n_points: int) -> torch.Tensor:
    """The (B, N) bool bitmap a ScoredSet is equivalent to."""
    b, c = sset.ids.shape
    bitmap = torch.zeros((b, n_points), dtype=torch.bool,
                         device=sset.ids.device)
    if c == 0:
        return bitmap
    valid = sset.ids != ops.SET_PAD
    return _bitmap_or(bitmap, sset.ids.clamp(0, n_points - 1), valid)


def _scored_lookup(scored, ids: torch.Tensor,
                   shard: ShardCtx | None = None) -> torch.Tensor:
    """(B, K) bool: which (valid) ids are already in the dedup state.

    A sorted set is replicated under a :class:`ShardCtx` too, so its local
    op is the whole answer, with no collective."""
    if isinstance(scored, ScoredSet):
        return ops.sorted_set_lookup(scored.ids, ids)
    if shard is None:
        return (ids >= 0) & scored.gather(1, ids.clamp(min=0).long())
    return collectives.bitmap_lookup(scored, ids)


def _scored_scatter(scored, ids: torch.Tensor, mark: torch.Tensor,
                    shard: ShardCtx | None = None):
    """Mark the kept lanes' ids in the dedup state (bitmap: in place)."""
    if isinstance(scored, ScoredSet):
        pad = torch.full_like(ids, ops.SET_PAD)
        merged = ops.sorted_set_merge(scored.ids, torch.where(mark, ids, pad))
        return ScoredSet(ids=merged,
                         count=scored.count + mark.sum(dim=1, dtype=_I32))
    if shard is None:
        return _bitmap_or(scored, ids.clamp(min=0), mark)
    return collectives.bitmap_scatter(scored, ids, mark)


def init_state(entry_ids: torch.Tensor, *, n_points: int, pool_size: int,
               quota, scored_init=None, calls_init=0, dedup: str = "bitmap",
               set_capacity: int | None = None,
               shard: ShardCtx | None = None):
    """Empty pools + the entry wave, quota-masked but not yet scored.

    Returns ``(state, safe_entries (B, E0), keep (B, E0))``; the caller
    scores ``safe_entries`` and feeds the result to :func:`commit_scores`.
    ``scored`` / ``n_calls`` already account for the kept entries. Under a
    :class:`ShardCtx` the bitmap is allocated as the per-shard column
    slices (entry marks land on their owners); the sorted set is
    replicated.
    """
    b, _ = entry_ids.shape
    dev = entry_ids.device
    entry_ids = _positional_dedup(entry_ids.to(_I32))
    valid = entry_ids >= 0
    order_idx = torch.cumsum(valid.to(_I32), dim=1, dtype=_I32) - 1
    quota = _per_query(quota, b, dev)
    calls0 = _per_query(calls_init, b, dev)
    keep = valid & (order_idx < (quota - calls0)[:, None])
    safe = torch.where(keep, entry_ids, torch.full_like(entry_ids, -1))

    if scored_init is not None:
        if isinstance(scored_init, ScoredSet):
            scored = ScoredSet(scored_init.ids.clone(),
                               scored_init.count.clone())
        elif shard is not None:
            scored = tuple(t.clone() for t in scored_init)
        else:
            scored = scored_init.clone()
    elif dedup == "sorted":
        if set_capacity is None:
            raise ValueError("dedup='sorted' needs a static set_capacity")
        scored = empty_scored_set(b, int(set_capacity), dev)
    elif shard is not None:
        scored = tuple(torch.zeros((b, shard.n_local), dtype=torch.bool,
                                   device=d) for d in shard.devices)
    else:
        scored = torch.zeros((b, n_points), dtype=torch.bool, device=dev)
    scored = _scored_scatter(scored, safe, keep, shard)
    n_calls = calls0 + keep.sum(dim=1, dtype=_I32)

    p = pool_size
    state = BatchedSearchState(
        pool_ids=torch.full((b, p), -1, dtype=_I32, device=dev),
        pool_dists=torch.full((b, p), float("inf"), device=dev),
        expanded=torch.zeros((b, p), dtype=torch.bool, device=dev),
        scored=scored,
        n_calls=n_calls,
        n_steps=torch.zeros((b,), dtype=_I32, device=dev),
    )
    return state, safe, keep


def reset_slots(state: BatchedSearchState, reset, entry_ids: torch.Tensor,
                quota):
    """Re-initialize the rows in ``reset`` to a fresh entry wave.

    The slot pool's admission primitive: ``reset`` (B,) bool marks the rows
    recycled for newly admitted queries. Their pools, dedup state and
    counters are cleared and re-seeded from ``entry_ids`` as
    :func:`init_state` would (positional entry dedup, quota-masked keep,
    ``scored`` / ``n_calls`` paid at plan time). Rows outside ``reset``
    pass through bit for bit, and their lanes of ``safe`` are -1, so the
    entry :func:`commit_scores` is an exact no-op on them.

    Returns ``(state', safe (B, E0), keep (B, E0))``. The input state is
    not modified.
    """
    b = state.pool_ids.shape[0]
    dev = state.pool_ids.device
    reset = torch.as_tensor(reset, dtype=torch.bool, device=dev).expand(b)
    entry_ids = _positional_dedup(
        torch.as_tensor(entry_ids, dtype=_I32, device=dev))
    valid = entry_ids >= 0
    order_idx = torch.cumsum(valid.to(_I32), dim=1, dtype=_I32) - 1
    quota = _per_query(quota, b, dev)
    keep = valid & (order_idx < quota[:, None]) & reset[:, None]
    safe = torch.where(keep, entry_ids, torch.full_like(entry_ids, -1))

    rm = reset[:, None]
    scored = state.scored
    if isinstance(scored, ScoredSet):
        scored = ScoredSet(
            ids=torch.where(rm, torch.full_like(scored.ids, ops.SET_PAD),
                            scored.ids),
            count=torch.where(reset, torch.zeros_like(scored.count),
                              scored.count))
    else:
        scored = scored & ~rm  # a new tensor: the scatter below is in place
    scored = _scored_scatter(scored, safe, keep)
    state = BatchedSearchState(
        pool_ids=torch.where(rm, torch.full_like(state.pool_ids, -1),
                             state.pool_ids),
        pool_dists=torch.where(rm, torch.full_like(state.pool_dists,
                                                   float("inf")),
                               state.pool_dists),
        expanded=state.expanded & ~rm,
        scored=scored,
        n_calls=torch.where(reset, keep.sum(dim=1, dtype=_I32),
                            state.n_calls),
        n_steps=torch.where(reset, torch.zeros_like(state.n_steps),
                            state.n_steps),
    )
    return state, safe, keep


def grow_state(state: BatchedSearchState, *, pool_size: int | None = None,
               set_capacity: int | None = None) -> BatchedSearchState:
    """Right-pad a state's static shapes, an exact semantic no-op.

    The slot pool grows its resident state when an admitted request needs
    a larger pool (P) or sorted-set capacity (C) than any before it. Pools
    are streaming exact top-P structures, so appended (-1, +inf,
    unexpanded) lanes never alter the surviving prefix, and ``ops.SET_PAD``
    sorts to the tail of each ascending ScoredSet row. A smaller value
    keeps the current shape (shrinking could drop live entries).
    """
    pool_ids, pool_dists, expanded = (
        state.pool_ids, state.pool_dists, state.expanded)
    p = pool_ids.shape[1]
    if pool_size is not None and pool_size > p:
        pad = (0, pool_size - p)
        pool_ids = torch.nn.functional.pad(pool_ids, pad, value=-1)
        pool_dists = torch.nn.functional.pad(pool_dists, pad,
                                             value=float("inf"))
        expanded = torch.nn.functional.pad(expanded, pad, value=False)
    scored = state.scored
    if (isinstance(scored, ScoredSet) and set_capacity is not None
            and set_capacity > scored.capacity):
        scored = ScoredSet(
            ids=torch.nn.functional.pad(
                scored.ids, (0, set_capacity - scored.capacity),
                value=ops.SET_PAD),
            count=scored.count)
    return state._replace(pool_ids=pool_ids, pool_dists=pool_dists,
                          expanded=expanded, scored=scored)


def early_resolve(state: BatchedSearchState, rows) -> BatchedSearchState:
    """Close the frontier of the masked ``rows``, the inverse of
    :func:`reset_expanded`: every pool lane is marked expanded, so
    :func:`active_mask` reports the row inactive whatever budget it has
    left. The serving layer freezes a row it resolved early (a deadline
    expired mid-flight, or a degraded answer) so no later plan re-expands
    it. Pools, dedup state and counters are untouched, and the other rows
    pass through bit for bit. ``rows`` is a (B,) bool mask or a scalar.
    """
    b = state.pool_ids.shape[0]
    rows = torch.as_tensor(rows, dtype=torch.bool,
                           device=state.expanded.device).expand(b)
    return state._replace(expanded=state.expanded | rows[:, None])


def active_mask(state: BatchedSearchState, *, beam_width, quota,
                max_steps) -> torch.Tensor:
    """(B,) — which queries still have an open frontier, budget and steps."""
    b, p = state.pool_ids.shape
    dev = state.pool_ids.device
    L = _per_query(beam_width, b, dev)
    in_beam = torch.arange(p, device=dev)[None, :] < L[:, None]
    frontier = (~state.expanded) & torch.isfinite(state.pool_dists) & in_beam
    return (frontier.any(dim=1)
            & (state.n_calls < _per_query(quota, b, dev))
            & (state.n_steps < _per_query(max_steps, b, dev)))


def reset_expanded(state: BatchedSearchState,
                   rows) -> BatchedSearchState:
    """Re-open the frontier of the masked ``rows`` (clear ``expanded``).

    The cover-tree descent expands the same surviving centers again at the
    next, finer level; between levels it clears their flags so
    :func:`plan_step` sees the whole pool prefix afresh. ``rows`` is a (B,)
    bool mask or a scalar; pools, dedup state and counters are untouched.
    """
    b = state.pool_ids.shape[0]
    rows = torch.as_tensor(rows, dtype=torch.bool,
                           device=state.expanded.device).expand(b)
    return state._replace(expanded=state.expanded & ~rows[:, None])


def plan_step(state: BatchedSearchState, adjacency: torch.Tensor, *,
              beam_width, quota, max_steps, expand_width=1,
              expand_cap: int | None = None, wave_dedup: bool = True,
              shard: ShardCtx | None = None, level=None):
    """One expansion wave: pick frontiers, gather fanout, mask to the quota.

    Returns ``(state', safe (B, E*R), keep (B, E*R), active (B,))``;
    ``state'`` has ``expanded`` / ``scored`` / ``n_calls`` / ``n_steps``
    advanced (a wave is paid for when planned). Frozen queries plan an
    all-masked wave, which commits as an exact no-op. A row at expand_width
    1 keeps the historical quirk of paying for duplicate ids inside one
    adjacency row twice. Under a :class:`ShardCtx` the lookup ORs the
    owners' bitmap answers and the scatter lands on the owners only; the
    rest of the plan runs on the replicated state, so the wave is the
    unsharded one.

    ``level``, a (B,) int vector (or a scalar), switches the fanout table
    from a flat ``(N, R)`` graph to a level-stacked ``(L, N, R)`` one: row b
    reads ``adjacency[level[b], vertex]`` (the cover tree's child slabs).
    ``wave_dedup=False`` skips the same-wave positional dedup, which is
    safe only when the expanded rows' fanouts are disjoint (child slabs
    partition the next level).
    """
    b, p = state.pool_ids.shape
    dev = state.pool_ids.device
    L = _per_query(beam_width, b, dev)
    if expand_cap is None:
        expand_cap = _static_quota_bound(expand_width)
    E = max(int(expand_cap), 1)
    ew = _per_query(expand_width, b, dev)
    r = adjacency.shape[-1]
    quota = _per_query(quota, b, dev)

    active = active_mask(state, beam_width=L, quota=quota,
                         max_steps=max_steps)
    pos = torch.arange(p, device=dev)
    open_ = ((~state.expanded) & torch.isfinite(state.pool_dists)
             & (pos[None, :] < L[:, None]))
    rank = torch.cumsum(open_.to(_I32), dim=1, dtype=_I32) - 1
    sel = open_ & (rank < ew[:, None]) & active[:, None]
    expanded = state.expanded | sel
    # slot positions of the selected vertices in pool order (p == none):
    # the j-th selected slot lands in column j, the rest in a spare column
    slot = torch.full((b, E + 1), p, dtype=torch.long, device=dev)
    col = torch.where(sel, rank.long(), torch.full_like(rank, E, dtype=torch.long))
    slot.scatter_(1, col.clamp(max=E), pos.expand(b, p))
    slot_pos = slot[:, :E]
    has = slot_pos < p
    verts = torch.where(
        has, state.pool_ids.gather(1, slot_pos.clamp(max=p - 1)),
        torch.full_like(slot_pos, -1, dtype=_I32))

    if level is None:
        nbrs = adjacency[verts.clamp(min=0).long()]  # (B, E, R)
    else:
        lev = _per_query(level, b, dev).long()
        nbrs = adjacency[lev[:, None], verts.clamp(min=0).long()]
    nbrs = torch.where((verts >= 0)[:, :, None], nbrs,
                       torch.full_like(nbrs, -1))
    cand = nbrs.reshape(b, E * r)
    if E > 1 and wave_dedup:
        cand = torch.where((ew > 1)[:, None], _positional_dedup(cand), cand)
    fresh = (cand >= 0) & ~_scored_lookup(state.scored, cand, shard)
    call_idx = torch.cumsum(fresh.to(_I32), dim=1, dtype=_I32) - 1
    keep = fresh & (call_idx < (quota - state.n_calls)[:, None])
    safe = torch.where(keep, cand, torch.full_like(cand, -1))

    scored = _scored_scatter(state.scored, safe, keep, shard)
    n_calls = state.n_calls + keep.sum(dim=1, dtype=_I32)
    n_steps = state.n_steps + active.to(_I32)
    state = state._replace(expanded=expanded, scored=scored, n_calls=n_calls,
                           n_steps=n_steps)
    return state, safe, keep, active


def commit_scores(state: BatchedSearchState, safe: torch.Tensor,
                  keep: torch.Tensor, dists: torch.Tensor) -> BatchedSearchState:
    """Merge a scored wave into the pools (masked lanes are +inf no-ops)."""
    d = torch.where(keep, dists.float(), torch.full_like(dists, float("inf"),
                                                         dtype=torch.float32))
    pool_ids, pool_dists, expanded = ops.merge_pool_batch(
        state.pool_ids, state.pool_dists, state.expanded, safe, d)
    return state._replace(pool_ids=pool_ids, pool_dists=pool_dists,
                          expanded=expanded)


def batched_greedy_search(
    dist_fn_batch: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    adjacency: torch.Tensor,
    query_ctx,
    entry_ids: torch.Tensor,
    *,
    n_points: int,
    beam_width,
    pool_size: int | None = None,
    quota=NO_QUOTA,
    expand_width: int = 1,
    max_steps=None,
    scored_init=None,
    calls_init=0,
    dedup: str = "auto",
    set_capacity: int | None = None,
    shard: ShardCtx | None = None,
) -> SearchResult:
    """Greedy beam search over ``adjacency`` for a whole query batch.

    ``dist_fn_batch(query_ctx, ids (B, K) int32) -> (B, K) f32`` scores a
    wave (ids < 0 -> +inf); :meth:`EmbeddingMetric.dists_batch` and
    :func:`fused_dist_fn` both satisfy it. ``beam_width`` / ``quota`` /
    ``max_steps`` may be scalars or (B,) vectors; a (B,) beam width needs an
    explicit ``pool_size`` and ``max_steps``. Returns pools sorted ascending
    by distance and the (B, N) scored bitmap. ``shard`` runs the loop over
    a corpus mesh (``dist_fn_batch`` must then be the sharded wave; use
    :func:`sharded_greedy_search`, which sets this up); with the bitmap
    backend ``scored`` is then the tuple of the shards' column slices.
    """
    adjacency = adjacency.to(_I32)
    if adjacency.shape[0] != n_points:
        raise ValueError(f"adjacency has {adjacency.shape[0]} rows, "
                         f"n_points={n_points}")
    b, e0 = entry_ids.shape
    L = beam_width
    if isinstance(L, (int, np.integer)) or getattr(L, "ndim", 0) == 0:
        L = int(L)
        P = max(pool_size or 0, L, e0)
        if max_steps is None:
            max_steps = 4 * L + 16
    else:
        if pool_size is None:
            raise ValueError(
                "a per-query (B,) beam_width needs an explicit pool_size")
        if max_steps is None:
            raise ValueError(
                "a per-query (B,) beam_width needs an explicit max_steps")
        P = max(pool_size, _static_quota_bound(L), e0)
    dedup, set_capacity = resolve_dedup(
        dedup, set_capacity, quota, n_points, scored_init, drive="fused")
    dev = adjacency.device
    quota = _per_query(quota, b, dev)
    L = _per_query(L, b, dev)
    max_steps = _per_query(max_steps, b, dev)
    # (B,) knobs live on the device once, so the loop never copies from host
    expand_cap = _static_quota_bound(expand_width)
    expand_width = _per_query(expand_width, b, dev)

    state, safe, keep = init_state(
        entry_ids.to(dev), n_points=n_points, pool_size=P, quota=quota,
        scored_init=scored_init, calls_init=calls_init, dedup=dedup,
        set_capacity=set_capacity, shard=shard)
    state = commit_scores(state, safe, keep, dist_fn_batch(query_ctx, safe))

    step = 0
    while True:
        if step % CHECK_EVERY == 0 and not bool(active_mask(
                state, beam_width=L, quota=quota, max_steps=max_steps).any()):
            break
        state, safe, keep, _ = plan_step(
            state, adjacency, beam_width=L, quota=quota, max_steps=max_steps,
            expand_width=expand_width, expand_cap=expand_cap, shard=shard)
        state = commit_scores(state, safe, keep,
                              dist_fn_batch(query_ctx, safe))
        step += 1

    scored = state.scored
    if isinstance(scored, ScoredSet):
        scored = scored_set_to_bitmap(scored, n_points)
    return SearchResult(state.pool_ids, state.pool_dists, scored,
                        state.n_calls, state.n_steps)


def fused_dist_fn(corpus, metric: str = "sqeuclidean", *, backend=None,
                  quantize: str | None = None):
    """A ``dist_fn_batch`` over embedding rows through ``ops.gather_score``.

    ``query_ctx`` must be the (B, dim) query embeddings. The matmul backend
    or a quantized residency builds the :class:`CorpusView` here, once; a
    prebuilt view passes straight through.
    """
    be = kernel_backend.resolve_backend(backend, quantize=quantize,
                                        _caller="beam.fused_dist_fn")
    if (be.matmul or be.quantize is not None
            or isinstance(corpus, kernel_backend.CorpusView)):
        src = kernel_backend.as_corpus_view(corpus, quantize=be.quantize)
    else:
        src = corpus

    def fn(q_embs, ids):
        return ops.gather_score(src, q_embs, ids, metric=metric, backend=be)

    return fn


def sharded_greedy_search(
    corpus,
    adjacency,
    query_embs,
    entry_ids,
    *,
    shards: int,
    metric: str = "sqeuclidean",
    mesh=None,
    beam_width,
    pool_size: int | None = None,
    quota=NO_QUOTA,
    expand_width: int = 1,
    max_steps=None,
    backend=None,
    quantize: str | None = None,
    dedup: str = "auto",
    set_capacity: int | None = None,
    device=None,
) -> SearchResult:
    """Batched greedy search over a corpus split into ``shards`` blocks.

    The corpus (raw rows or a ``CorpusView``) is placed in contiguous row
    blocks over ``mesh`` (``distributed.sharding.search_mesh``; without one,
    the first ``shards`` devices of ``device``'s type). Each wave is scored
    shard by shard with the shard-local kernel and summed in shard order;
    pools, counters and the merge stay replicated on the mesh's first
    device. The result, ``scored`` included, is bit-exact against
    :func:`batched_greedy_search` with :func:`fused_dist_fn` on one device
    under the same backend and residency.

    ``dedup`` resolves as the unsharded engine's fused drive does (``auto``
    -> bitmap): the bitmap is column-sharded with the corpus, the sorted set
    replicated. The matmul backend and quantized residency build the view
    once, here, and shard its norms and dequant parameters with the rows.
    ``shards=1`` is the single-device engine.
    """
    be = kernel_backend.resolve_backend(backend, quantize=quantize,
                                        _caller="beam.sharded_greedy_search")
    n_points = kernel_backend.corpus_rows(corpus).shape[0]
    if shards == 1:
        dev = kernel_backend.resolve_device(device)
        if not isinstance(corpus, kernel_backend.CorpusView):
            corpus = kernel_backend.as_tensor(corpus, dev)
        return batched_greedy_search(
            fused_dist_fn(corpus, metric, backend=be),
            kernel_backend.as_tensor(adjacency, dev, _I32),
            kernel_backend.as_tensor(query_embs, dev),
            kernel_backend.as_tensor(entry_ids, dev, _I32),
            n_points=n_points, beam_width=beam_width, pool_size=pool_size,
            quota=quota, expand_width=expand_width, max_steps=max_steps,
            dedup=dedup, set_capacity=set_capacity)
    if mesh is None:
        mesh = search_mesh(shards, device=device)
    if mesh.size != shards:
        raise ValueError(f"shards={shards} but the mesh has {mesh.size} "
                         "devices")
    want = kernel_backend.resolve_device(device)
    if any(d.type != want.type for d in mesh.devices):
        raise ValueError(f"the search runs on {want.type} but the mesh is "
                         f"{mesh.devices}")
    dev = mesh.devices[0]
    dedup, set_capacity = resolve_dedup(dedup, set_capacity, quota, n_points,
                                        drive="fused")

    if not isinstance(corpus, kernel_backend.CorpusView):
        corpus = kernel_backend.as_tensor(corpus, dev)
    quant = be.quantize
    if quant is None and isinstance(corpus, kernel_backend.CorpusView):
        quant = corpus.quantize
    if be.matmul or quant is not None:
        rows, sq, inv, sc, zp, n_local = shard_corpus_view(
            corpus, shards, quantize=be.quantize)
        blocks = [kernel_backend.CorpusView(
            rows=rows[s].to(d), sq_norms=sq[s].to(d), inv_norms=inv[s].to(d),
            scales=sc[s].to(d) if quant is not None else None,
            zero_points=zp[s].to(d) if zp.shape[-1] else None)
            for s, d in enumerate(mesh.devices)]
    else:
        stacked, n_local = shard_corpus(kernel_backend.corpus_rows(corpus),
                                        shards)
        blocks = [stacked[s].to(d) for s, d in enumerate(mesh.devices)]

    def dist_fn(q_embs, ids):
        return collectives.wave_gather_score(blocks, q_embs, ids,
                                             metric=metric, backend=be)

    entry_ids = kernel_backend.as_tensor(entry_ids, dev, _I32)
    bw_max = _static_quota_bound(beam_width)
    if max_steps is None:
        max_steps = 4 * bw_max + 16
    res = batched_greedy_search(
        dist_fn, kernel_backend.as_tensor(adjacency, dev, _I32),
        kernel_backend.as_tensor(query_embs, dev), entry_ids,
        n_points=n_points, beam_width=beam_width,
        pool_size=max(pool_size or 0, bw_max, entry_ids.shape[1]),
        quota=quota, expand_width=expand_width, max_steps=max_steps,
        dedup=dedup, set_capacity=set_capacity,
        shard=ShardCtx(mesh.devices, n_local))
    if dedup == "bitmap":
        # the slices side by side, cut to N (pad columns are never marked)
        scored = torch.cat([t.to(dev) for t in res.scored], dim=1)
        res = res._replace(scored=scored[:, :n_points].contiguous())
    return res
