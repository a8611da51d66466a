"""Dispatch layer for the kernels — one backend knob per search op.

``backend=`` is ``"ref" | "matmul"`` or a resolved
:class:`~repro_torch.kernels.backend.Backend`. The backend picks the form of
the score; the device of the tensors picks the route: a CUDA tensor launches
the hand-written kernels of :mod:`repro_torch.kernels.l2_topk` on every
backend, a CPU tensor runs their plain versions. Ops that gather corpus rows
take a raw (N, dim) tensor or a prebuilt ``CorpusView`` — build the view
outside any hot loop so the norms are computed once per corpus.

:func:`flash_attention`, :func:`flash_decode` and :func:`embedding_bag` are
re-exported from their kernel modules. They take the JAX ops' keywords and
follow the same device rule. They compute the
Pallas kernels' function (JAX's ``backend="pallas"``): a row with no valid
key gives 0, not the oracle's NaN. JAX's ``block_q`` / ``block_k`` are TPU
tiling and are not taken; the CUDA kernels choose their own tiles.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import l2_topk as _lt
from repro_torch.kernels.backend import (Backend, CorpusView, as_corpus_view,
                                         corpus_rows, resolve_backend)
from repro_torch.kernels.embedding_bag import embedding_bag  # noqa: F401
from repro_torch.kernels.flash_attention import (  # noqa: F401
    flash_attention, flash_decode)


def _view_for(corpus, be: Backend, caller: str):
    """A prebuilt view is scored as-is (a conflicting ``be.quantize``
    raises); a raw tensor is wrapped when the backend needs a view."""
    if isinstance(corpus, CorpusView):
        if be.quantize is not None and corpus.quantize != be.quantize:
            raise ValueError(
                f"{caller}: backend asks quantize={be.quantize!r} but the "
                f"prebuilt view carries quantize={corpus.quantize!r}")
        return corpus
    if be.matmul or be.quantize is not None:
        return as_corpus_view(corpus, quantize=be.quantize)
    return corpus


def gather_score(corpus, queries, ids, *, metric="sqeuclidean", backend=None,
                 quantize=None):
    """Fused gather→score for a whole query batch: (B, K) ids -> (B, K).

    ``ref`` scores in gather-then-reduce form (a quantized view is
    dequantized in registers first), ``matmul`` in norm-cache form.
    """
    be = resolve_backend(backend, quantize=quantize,
                         _caller="ops.gather_score")
    src = _view_for(corpus, be, "ops.gather_score")
    ids = ids.to(torch.int32)
    if be.matmul:
        return _lt.gather_score(src.rows, queries, ids, metric=metric,
                                meta=_lt.pack_row_meta(src), matmul=True)
    if isinstance(src, CorpusView) and src.quantize is not None:
        return _lt.gather_score(src.rows, queries, ids, metric=metric,
                                meta=_lt.pack_row_meta(src))
    return _lt.gather_score(corpus_rows(src), queries, ids, metric=metric)


def gather_l2(corpus, queries, ids, *, backend=None):
    """The historical sqeuclidean entry of :func:`gather_score`."""
    return gather_score(corpus, queries, ids, metric="sqeuclidean",
                        backend=backend)


def gather_score_local(corpus_local, queries, ids, offset, *,
                       metric="sqeuclidean", backend=None, quantize=None):
    """Shard-local gather→score over global ids: (B, K) -> (B, K) partials.

    ``corpus_local`` is one shard's block (raw rows or its ``CorpusView``,
    whose norms and dequant parameters shard with the rows), global rows
    ``[offset, offset + n_local)``. Owned lanes carry exactly the value of
    :func:`gather_score` under the same backend; foreign and padding lanes
    carry 0.0, so the sum over shards rebuilds the unsharded wave (the
    caller masks ids < 0 back to +inf).
    """
    be = resolve_backend(backend, quantize=quantize,
                         _caller="ops.gather_score_local")
    src = _view_for(corpus_local, be, "ops.gather_score_local")
    ids = ids.to(torch.int32)
    if be.matmul:
        return _lt.gather_score_local(src.rows, queries, ids, offset,
                                      metric=metric,
                                      meta=_lt.pack_row_meta(src),
                                      matmul=True)
    if isinstance(src, CorpusView) and src.quantize is not None:
        return _lt.gather_score_local(src.rows, queries, ids, offset,
                                      metric=metric,
                                      meta=_lt.pack_row_meta(src))
    return _lt.gather_score_local(corpus_rows(src), queries, ids, offset,
                                  metric=metric)


def local_topk(ids, dists, k):
    """Per-row best ``k`` by distance, ties to the lowest index.

    The per-shard cut before a gather-merge: each shard sends only its k
    best (id, dist) pairs. ``k`` may exceed the row width: the cut is
    clamped to it and padded with (-1, +inf) lanes, which sort last in any
    later merge. The order is a stable sort of an f32 view of the keys
    (``lax.top_k``'s tie rule, which ``torch.topk`` does not promise); the
    distances keep their dtype.
    """
    b, width = ids.shape
    kk = min(k, width)
    order = torch.sort(dists.float(), dim=1, stable=True).indices[:, :kk]
    out_ids = ids.gather(1, order)
    out_dists = dists.gather(1, order)
    if kk < k:
        out_ids = torch.cat([out_ids, out_ids.new_full((b, k - kk), -1)], 1)
        out_dists = torch.cat(
            [out_dists, out_dists.new_full((b, k - kk), float("inf"))], 1)
    return out_ids, out_dists


# Padding sentinel for the sorted-membership dedup arrays: larger than any
# real vertex id, so pads always sort to the tail of an ascending row.
SET_PAD = torch.iinfo(torch.int32).max


def sorted_set_merge(set_ids, new_ids):
    """Insert a wave of ids into per-row ascending membership arrays.

    ``set_ids`` (B, C) int32 ascending, :data:`SET_PAD` padded; ``new_ids``
    (B, K) with masked lanes set to ``SET_PAD``. Returns the C smallest of
    the union — every real entry while the caller inserts at most C ids.
    """
    c = set_ids.shape[1]
    if c == 0:
        return set_ids
    cat = torch.cat([set_ids, new_ids.to(torch.int32)], dim=1)
    return torch.sort(cat, dim=1).values[:, :c].contiguous()


def sorted_set_lookup(set_ids, ids):
    """(B, K) bool membership of ``ids`` in ascending per-row sets."""
    c = set_ids.shape[1]
    if c == 0:
        return torch.zeros(ids.shape, dtype=torch.bool, device=ids.device)
    ids = ids.to(torch.int32)
    pos = torch.searchsorted(set_ids, ids)
    hit = set_ids.gather(1, pos.clamp(max=c - 1)) == ids
    return (ids >= 0) & hit


def sorted_set_unique_count(set_ids):
    """(B,) distinct real ids per ascending row."""
    b, c = set_ids.shape
    if c == 0:
        return torch.zeros((b,), dtype=torch.int32, device=set_ids.device)
    first = torch.ones((b, 1), dtype=torch.bool, device=set_ids.device)
    distinct = torch.cat([first, set_ids[:, 1:] != set_ids[:, :-1]], dim=1)
    return (distinct & (set_ids != SET_PAD)).sum(dim=1, dtype=torch.int32)


def frontier_count(pool_dists, radius):
    """(B,) pool entries within ``min + radius`` of each row's best.

    The cover-tree descent's candidate set at a level is the prefix of the
    sorted pool within the radius of the row minimum; its size is the expand
    width of the level's wave. ``radius`` (a float or (B,)) is taken in the
    pools' dtype; +inf counts every finite entry, an all-+inf row counts 0.
    """
    finite = torch.isfinite(pool_dists)
    dmin = torch.where(finite, pool_dists, float("inf")).amin(dim=1)
    r = torch.as_tensor(radius, dtype=pool_dists.dtype,
                        device=pool_dists.device).expand(dmin.shape)
    within = finite & (pool_dists <= (dmin + r)[:, None])
    return within.sum(dim=1, dtype=torch.int32)


def beam_merge_topk(beam_ids, beam_dists, cand_ids, cand_dists):
    """Stable best-(B, L) of (beam ‖ candidates) — the merge kernel."""
    return _lt.beam_merge_topk(beam_ids, beam_dists, cand_ids, cand_dists)


def merge_pool_batch(pool_ids, pool_dists, expanded, cand_ids, cand_dists):
    """Batched (beam ‖ fanout) pool merge with the ``expanded`` payload.

    Stable: ties, +inf padding included, keep the earlier position, so an
    all-masked wave is an exact no-op. Distances keep the promoted input
    dtype.
    """
    return _lt.merge_pool_batch(pool_ids, pool_dists, expanded, cand_ids,
                                cand_dists)

