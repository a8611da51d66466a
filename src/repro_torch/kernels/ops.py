"""Dispatch layer for the search kernels — one backend knob per op.

``backend=`` is ``"ref" | "matmul"`` or a resolved
:class:`~repro_torch.kernels.backend.Backend`. The backend picks the form of
the score; the device of the tensors picks the route: a CUDA tensor launches
the hand-written kernels of :mod:`repro_torch.kernels.l2_topk` on every
backend, a CPU tensor runs their plain versions. Ops that gather corpus rows
take a raw (N, dim) tensor or a prebuilt ``CorpusView`` — build the view
outside any hot loop so the norms are computed once per corpus.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import l2_topk as _lt
from repro_torch.kernels.backend import (Backend, CorpusView, as_corpus_view,
                                         corpus_rows, resolve_backend)


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
