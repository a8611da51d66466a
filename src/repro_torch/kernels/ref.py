"""Plain PyTorch oracles for the kernels (the correctness contract).

Each ``<name>_ref`` is the definition its Hopper kernel must match, written
as the JAX package's ``repro.kernels.ref`` writes it. The search oracles are
also the plain versions the kernel wrappers run on CPU tensors. The flash
and bag oracles keep the JAX ref's own edge behaviour (NaN for a row with no
valid key, the bag summed in the table's dtype); their kernels compute the
Pallas kernels' function instead, whose plain versions live beside them.
"""
from __future__ import annotations

import math

import torch

_EPS = 1e-12


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True,
                        sm_scale: float | None = None) -> torch.Tensor:
    """q (B, H, Sq, dh); k, v (B, H, Skv, dh|dv) -> (B, H, Sq, dv).

    Plain softmax; causal keys are aligned bottom-right (queries sit at the
    end of the KV window), and a row with no valid key is NaN.
    """
    sq, dh = q.shape[2], q.shape[3]
    skv = k.shape[2]
    sm_scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(dh)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        mask = (torch.arange(skv, device=q.device)[None, :]
                <= torch.arange(sq, device=q.device)[:, None] + (skv - sq))
        s = torch.where(mask[None, None], s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def flash_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     length, sm_scale: float | None = None) -> torch.Tensor:
    """One query token: q (B, H, dh); k, v (B, S, H, dh|dv) -> (B, H, dv).

    ``length`` is an int or (B,): keys at or past it are masked. A row of
    length 0 is NaN.
    """
    dh = q.shape[2]
    s = k.shape[1]
    sm_scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(dh)
    logits = torch.einsum("bhd,bshd->bhs", q.float(), k.float()) * sm_scale
    valid = (torch.arange(s, device=q.device)[None, None, :]
             < torch.as_tensor(length, device=q.device).reshape(-1, 1, 1))
    logits = torch.where(valid, logits, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhs,bshd->bhd", p, v.float()).to(q.dtype)


def embedding_bag_ref(table: torch.Tensor, idx: torch.Tensor,
                      mode: str = "sum") -> torch.Tensor:
    """table (V, D); idx (B, L) with -1 padding -> (B, D) reduced bags, in
    the table's dtype throughout."""
    rows = table[idx.clamp(min=0).long()]
    mask = (idx >= 0).to(table.dtype)
    out = (rows * mask[..., None]).sum(dim=1)
    if mode == "mean":
        out = out / mask.sum(-1, keepdim=True).clamp(min=1.0)
    return out


def _score_rows(rows: torch.Tensor, queries: torch.Tensor, ids: torch.Tensor,
                metric: str) -> torch.Tensor:
    """Gather-then-reduce score of f32 rows (B, K, dim) against queries."""
    q = queries[:, None].float()  # (B, 1, dim)
    if metric in ("l2", "sqeuclidean"):
        diff = rows - q
        d = (diff * diff).sum(-1)
        if metric == "l2":
            d = torch.sqrt(d)
    elif metric == "ip":
        d = -(rows * q).sum(-1)
    elif metric == "cosine":
        qn = torch.rsqrt((q * q).sum(-1) + _EPS)
        rn = torch.rsqrt((rows * rows).sum(-1) + _EPS)
        d = 1.0 - (rows * q).sum(-1) * qn * rn
    else:
        raise ValueError(f"unknown metric {metric!r}")
    return torch.where(ids >= 0, d, torch.full_like(d, float("inf")))


def gather_score_ref(corpus: torch.Tensor, queries: torch.Tensor,
                     ids: torch.Tensor,
                     metric: str = "sqeuclidean") -> torch.Tensor:
    """corpus (N, dim); queries (B, dim); ids (B, K) -> (B, K) f32.

    ids < 0 -> +inf. "ip" is negated, "cosine" one-minus.
    """
    rows = corpus[ids.clamp(min=0).long()].float()  # (B, K, dim)
    return _score_rows(rows, queries, ids, metric)


def l2_gather_dists_ref(corpus: torch.Tensor, queries: torch.Tensor,
                        ids: torch.Tensor) -> torch.Tensor:
    """Historical sqeuclidean entry of :func:`gather_score_ref`."""
    return gather_score_ref(corpus, queries, ids, metric="sqeuclidean")


def dequant_rows_ref(rows: torch.Tensor, scales: torch.Tensor,
                     zero_points: torch.Tensor | None = None) -> torch.Tensor:
    """THE dequantization semantics: f32 ``(code - zp) * scale``."""
    f = rows.float()
    if zero_points is not None:
        f = f - zero_points[..., None].float()
    return f * scales[..., None].float()


def gather_score_quant_ref(rows: torch.Tensor, scales: torch.Tensor,
                           zero_points: torch.Tensor | None,
                           queries: torch.Tensor, ids: torch.Tensor,
                           metric: str = "sqeuclidean") -> torch.Tensor:
    """:func:`gather_score_ref` over :func:`dequant_rows_ref` of the rows."""
    safe = ids.clamp(min=0).long()
    zp = None if zero_points is None else zero_points[safe]
    deq = dequant_rows_ref(rows[safe], scales[safe], zp)  # (B, K, dim)
    return _score_rows(deq, queries, ids, metric)


def owned_local(ids: torch.Tensor, offset: int, n_local: int):
    """(owned (B, K) bool, local ids with every other lane -1)."""
    loc = ids - offset
    owned = (ids >= 0) & (loc >= 0) & (loc < n_local)
    return owned, torch.where(owned, loc, torch.full_like(loc, -1))


def gather_score_local_ref(corpus_local: torch.Tensor, queries: torch.Tensor,
                           ids: torch.Tensor, offset: int,
                           metric: str = "sqeuclidean") -> torch.Tensor:
    """Shard-local :func:`gather_score_ref` over global ids (sum identity).

    ``corpus_local`` (n_local, dim) holds global rows [offset, offset +
    n_local). Owned lanes carry the exact per-lane value of
    :func:`gather_score_ref` on local row ``id - offset``; foreign and
    padding lanes carry 0.0, so the sum of every shard's partials is the
    unsharded wave (x + 0.0 == x; each id has one owner). The caller masks
    ids < 0 back to +inf after the sum.
    """
    owned, loc = owned_local(ids, offset, corpus_local.shape[0])
    d = gather_score_ref(corpus_local, queries, loc, metric=metric)
    return torch.where(owned, d, torch.zeros_like(d))


def gather_score_local_quant_ref(rows_local: torch.Tensor,
                                 scales_local: torch.Tensor,
                                 zp_local: torch.Tensor | None,
                                 queries: torch.Tensor, ids: torch.Tensor,
                                 offset: int,
                                 metric: str = "sqeuclidean") -> torch.Tensor:
    """Shard-local :func:`gather_score_quant_ref` (same owned-lane contract
    as :func:`gather_score_local_ref`)."""
    owned, loc = owned_local(ids, offset, rows_local.shape[0])
    d = gather_score_quant_ref(rows_local, scales_local, zp_local, queries,
                               loc, metric=metric)
    return torch.where(owned, d, torch.zeros_like(d))


def beam_merge_topk_ref(beam_ids, beam_dists, cand_ids, cand_dists):
    """Merge (B, L) beam with (B, K) candidates, best (B, L) by dist."""
    L = beam_ids.shape[1]
    ids = torch.cat([beam_ids, cand_ids], dim=1)
    d = torch.cat([beam_dists, cand_dists], dim=1)
    order = torch.argsort(d, dim=1, stable=True)[:, :L]
    return ids.gather(1, order), d.gather(1, order)


def merge_pool_batch_ref(pool_ids, pool_dists, expanded, cand_ids,
                         cand_dists):
    """Stable (beam ‖ fanout) merge keeping the best pool-width per query.

    The ``expanded`` payload rides along (candidates enter unexpanded). Ties
    — +inf padding included — keep the earlier position, so merging an
    all-masked wave is an exact no-op.
    """
    p = pool_ids.shape[1]
    ids = torch.cat([pool_ids, cand_ids], dim=1)
    d = torch.cat([pool_dists, cand_dists], dim=1)
    exp = torch.cat([expanded, torch.zeros_like(cand_ids, dtype=torch.bool)],
                    dim=1)
    order = torch.argsort(d, dim=1, stable=True)[:, :p]
    take = lambda a: a.gather(1, order)
    return take(ids), take(d), take(exp)
