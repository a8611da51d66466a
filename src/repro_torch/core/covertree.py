"""Cover Tree under the bi-metric framework (paper Appendix B), on the engine.

Algorithm 2 builds a cover tree with the *cheap* metric d and slack
``T = C``; Algorithm 3 answers queries with the *expensive* metric D,
counting D evaluations (memoized per query: a vertex is paid for once even
if it appears at many levels, since C_i ⊆ C_{i-1}).

**Build** (:func:`build`) gives the tree of the JAX package's NumPy build
for the same ``x``, ``T``, ``seed`` and ``max_levels``: the same draws of
``np.random.default_rng(seed)`` on the host, in the same order, and the same
greedy. At level i a shuffled candidate becomes a member iff no earlier
member lies within ``2^i / T`` (scaled f64 units), and each covered point's
parent is the first member, in greedy order, that covers it (a member is its
own parent). The distance work runs in f64 on the build's device, in blocks
of :data:`_BLOCK` candidates of the shuffled order: the block's uncovered
candidates are resolved among themselves in order, then its members mark
what they cover among the still-uncovered points. Every ``<= r`` test gives
what NumPy's direct form ``sqrt(sum((a - b)^2)) * scale <= r`` gives:

* the product form ``|a|^2 + |b|^2 - 2 a.b`` (one f64 matmul per tile)
  settles a pair only where its error bound (:data:`_MARGIN`, far above f64
  rounding at any realistic width) leaves the test no doubt;
* the pairs it cannot settle, those within that bound of the radius, are
  computed in the direct form, summed in NumPy's pairwise order
  (:func:`_np_sum`), so the test is NumPy's bit for bit.

**Queries** run on the batched engine. :func:`flatten` stacks the children
into a level-stacked table ``(depth-1, N, R)`` (row ``p`` of slab ``j`` is
``{p} ∪ children_j(p)``, ascending, -1 padded) that
:func:`repro_torch.core.beam.plan_step` indexes through its ``level=``
operand. The pools are sorted and the thresholds shrink down the levels, so
Algorithm 3's candidate set at a level is the pool prefix within the last
radius of the row minimum (:func:`repro_torch.kernels.ops.frontier_count`),
which is also the wave's expand width. Each level is planned in chunks
against its slab, every chunk before any commit (a commit in the middle of
a level would let finer points displace frontier members from the prefix),
then scored and committed. The memoized D-call set is the engine's dedup
state, so each wave runs ``gather_score`` and the merge kernel on the card.

:func:`search` is the per-query NumPy oracle, a copy of the JAX package's:
at matched ε and an unbounded (or un-hit) quota the batched drive returns
the same neighbours and the same D-call counts; under truncation only the
counts match (both admit ``quota`` calls, possibly of other ids).
"""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import beam
from repro_torch.kernels import backend as kernel_backend
from repro_torch.kernels import ops

DistToMany = Callable[[np.ndarray], np.ndarray]  # ids -> D(q, ids)

_I32 = torch.int32
#: candidates of the shuffled order resolved together; any width gives the
#: same tree (width 1 is the plain sequential greedy)
_BLOCK = 1024
#: relative error bound granted to the product form: ``|a|^2 + |b|^2 -
#: 2 a.b`` and the direct sum are each within ``(dim + 3) * 2^-53 *
#: (|a|^2 + |b|^2)`` of the true value, far below this for dim < 10^6
_MARGIN = 1e-9
#: most cells of one product-form tile
_CELLS = 1 << 26
#: rows the closest-pair estimate samples (the JAX build's 4096)
_SAMPLE = 4096


class ChildMap(Mapping):
    """``children_j`` of one level: parent id -> ascending child ids.

    Read-only, over CSR arrays (``parents`` ascending, ``indptr``, ``kids``);
    a dict of one array per point costs seconds and much memory at a
    corpus of 10^5 points.
    """

    def __init__(self, parents: np.ndarray, indptr: np.ndarray,
                 kids: np.ndarray):
        self.parents = parents
        self.indptr = indptr
        self.kids = kids

    def __getitem__(self, p) -> np.ndarray:
        i = int(np.searchsorted(self.parents, p))
        if i == len(self.parents) or self.parents[i] != p:
            raise KeyError(p)
        return self.kids[self.indptr[i]:self.indptr[i + 1]]

    def __iter__(self):
        return iter(self.parents.tolist())

    def __len__(self) -> int:
        return len(self.parents)


@dataclasses.dataclass
class CoverTree:
    levels: list[np.ndarray]  # levels[j] = ids in cover C_{i_j}; j=0 is root level
    children: list[ChildMap]  # children[j][p] = ids in next level covered by p
    level_scales: list[float]  # 2^i (scaled d units) per level
    scale: float  # multiplier applied to raw distances
    T: float  # the paper's T (set to C at build time)
    n: int

    @property
    def depth(self) -> int:
        return len(self.levels)


# --------------------------------------------------------------------------
# Algorithm 2 on the device
# --------------------------------------------------------------------------
def _np_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in NumPy's pairwise order (``np.add.reduce``
    of a contiguous axis: eight running sums up to 128 elements, halves at a
    multiple of 8 above), so f64 sums are bit-equal to NumPy's."""
    n = x.shape[-1]
    if n < 8:
        res = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        for i in range(n):
            res = res + x[..., i]
        return res
    if n <= 128:
        m = n - n % 8
        r = x[..., 0:8]
        for i in range(8, m, 8):
            r = r + x[..., i:i + 8]
        r = r[..., 0::2] + r[..., 1::2]
        r = r[..., 0::2] + r[..., 1::2]
        res = r[..., 0] + r[..., 1]
        for i in range(m, n):
            res = res + x[..., i]
        return res
    n2 = n // 2
    n2 -= n2 % 8
    return _np_sum(x[..., :n2]) + _np_sum(x[..., n2:])


def _direct(xa: torch.Tensor, xb: torch.Tensor) -> torch.Tensor:
    """NumPy's ``((a - b) ** 2).sum(-1)`` row by row, bit for bit."""
    d = xa - xb
    return _np_sum(d * d)


def _estimate(xq, nq, xm, nm):
    """Product-form sums of squares, (Q, M) f64: row q against column m."""
    return torch.addmm(nq[:, None] + nm[None, :], xq, xm.T, alpha=-2.0)


def _maybe_within(est, nq, nm, thr2):
    """A superset of the (q, m) pairs whose direct sum can be <= ``thr2``:
    the estimate less its error bound, with the largest column norm."""
    slack = thr2 * (1 + _MARGIN) + _MARGIN * (nq + nm.max())
    return est <= slack[:, None]


def _within(x, sq, ia, ib, est, r, scale):
    """Exact ``sqrt(sum((x[a] - x[b])^2)) * scale <= r`` for the pairs
    ``(ia, ib)`` with product-form estimates ``est``: certified by the
    estimate where its bound allows, else computed in the direct form."""
    thr2 = (r / scale) ** 2
    err = _MARGIN * (sq[ia] + sq[ib])
    out = est + err <= thr2 * (1 - _MARGIN)
    band = ((est - err <= thr2 * (1 + _MARGIN)) & ~out).nonzero().squeeze(1)
    if band.numel():
        s = _direct(x[ia[band]], x[ib[band]])
        out[band] = torch.sqrt(s) * scale <= r
    return out


def _block_members(x, sq, live, r, scale) -> torch.Tensor:
    """Which of the block's uncovered candidates ``live`` (in greedy order)
    become members: those with no earlier member of the block within r
    (members of earlier blocks have covered everything within r of them)."""
    w = live.numel()
    if w == 1:
        return torch.ones(1, dtype=torch.bool, device=live.device)
    xl, nl = x[live], sq[live]
    est = _estimate(xl, nl, xl, nl)
    maybe = torch.tril(_maybe_within(est, nl, nl, (r / scale) ** 2), -1)
    k, j = maybe.nonzero().unbind(1)  # j earlier than k
    ok = _within(x, sq, live[k], live[j], est[k, j], r, scale)
    within = np.zeros((w, w), bool)
    within[k[ok].cpu().numpy(), j[ok].cpu().numpy()] = True
    member = np.ones(w, bool)
    for i in np.flatnonzero(within.any(1)):
        member[i] = not (within[i, :i] & member[:i]).any()
    return torch.from_numpy(member).to(live.device)


def _first_cover(x, sq, members, points, r, scale) -> torch.Tensor:
    """For each of ``points``, the index into ``members`` (greedy order) of
    the first member within r of it, or -1."""
    xm, nm = x[members], sq[members]
    thr2 = (r / scale) ** 2
    out = torch.full((points.numel(),), -1, dtype=torch.long,
                     device=points.device)
    rows = max(1, _CELLS // members.numel())
    for s in range(0, points.numel(), rows):
        pts = points[s:s + rows]
        est = _estimate(x[pts], sq[pts], xm, nm)
        maybe = _maybe_within(est, sq[pts], nm, thr2)
        lanes = torch.arange(pts.numel(), device=pts.device)
        while True:
            first = maybe.view(torch.uint8).argmax(dim=1)
            q = maybe[lanes, first].nonzero().squeeze(1)
            if q.numel() == 0:
                break
            m = first[q]
            ok = _within(x, sq, pts[q], members[m], est[q, m], r, scale)
            out[s + q[ok]] = m[ok]
            if bool(ok.all()):
                break
            # a candidate the direct form rejects: try the row's next one
            maybe[q[ok]] = False
            maybe[q[~ok], m[~ok]] = False
    return out


def _cover_level(x, sq, prev: torch.Tensor, order: torch.Tensor, r, scale):
    """One greedy ``r``-cover of the points ``prev`` taken in ``order``
    (positions into ``prev``). Returns the members' positions in greedy
    order and, per position, its parent's position."""
    xp, sp = x[prev], sq[prev]
    m = prev.numel()
    covered = torch.zeros(m, dtype=torch.bool, device=x.device)
    parent = torch.full((m,), -1, dtype=torch.long, device=x.device)
    members = []
    for s in range(0, m, _BLOCK):
        blk = order[s:s + _BLOCK]
        live = blk[~covered[blk]]
        if live.numel() == 0:
            continue
        mem = live[_block_members(xp, sp, live, r, scale)]
        alive = (~covered).nonzero().squeeze(1)
        first = _first_cover(xp, sp, mem, alive, r, scale)
        hit = first >= 0
        parent[alive[hit]] = mem[first[hit]]
        covered[alive[hit]] = True
        members.append(mem)
    return torch.cat(members), parent


def _closest_pair(x, sq) -> float:
    """min over i != j of NumPy's direct distance between rows of ``x``."""
    est = _estimate(x, sq, x, sq)
    est.fill_diagonal_(float("inf"))
    lo = est.min()
    if not torch.isfinite(lo):
        return float("inf")
    # the true minimum's estimate lies within two error bounds of the least
    cand = (est <= lo + 4 * _MARGIN * sq.max()).nonzero()
    cand = cand[cand[:, 0] != cand[:, 1]]
    s = _direct(x[cand[:, 0]], x[cand[:, 1]])
    return float(torch.sqrt(s.min()))


def build(
    x,
    *,
    T: float = 1.0,
    metric: str = "l2",
    seed: int = 0,
    max_levels: int = 64,
    device=None,
) -> CoverTree:
    """Algorithm 2: nested greedy covers C_i (2^i/T-covers of C_{i-1}),
    built on d, on ``device`` (the card unless ``device="cpu"``)."""
    if metric != "l2":
        raise ValueError("the cover tree is built under l2 only")
    dev = kernel_backend.resolve_device(device)
    rng = np.random.default_rng(seed)
    xt = kernel_backend.as_tensor(x, dev, torch.float64)
    n = xt.shape[0]
    sq = (xt * xt).sum(-1)

    # Scale so all pairwise distances are > 1 (WLOG step of Algorithm 2),
    # from the closest pair of a sample (exact for small n).
    if n <= _SAMPLE:
        idx = torch.arange(n, device=dev)
    else:
        idx = torch.from_numpy(
            rng.choice(n, size=_SAMPLE, replace=False)).to(dev)
    dmin = max(_closest_pair(xt[idx], sq[idx]), 1e-12)
    scale = 1.001 / dmin

    # levels bottom-up: C_0 = all points; C_i is a 2^i/T cover of C_{i-1}
    covers = [np.arange(n, dtype=np.int64)]
    parents: list[np.ndarray] = []  # parent id of each point of C_{i-1}
    i = 0
    while len(covers[-1]) > 1 and i < max_levels:
        i += 1
        r = (2.0**i) / T
        prev = covers[-1]
        remaining = prev.copy()
        rng.shuffle(remaining)
        order = torch.from_numpy(np.searchsorted(prev, remaining)).to(dev)
        prev_t = torch.from_numpy(prev).to(dev)
        mem, parent = _cover_level(xt, sq, prev_t, order, r, scale)
        covers.append(np.sort(prev[mem.cpu().numpy()]))
        parents.append(prev[parent.cpu().numpy()])

    # top-down ordering for the query recursion
    covers = covers[::-1]
    children = []
    for j, par in enumerate(parents[::-1]):
        pts = covers[j + 1]
        o = np.lexsort((pts, par))
        keys, starts = np.unique(par[o], return_index=True)
        indptr = np.append(starts, len(o)).astype(np.int64)
        children.append(ChildMap(keys, indptr, pts[o]))
    top_i = len(covers) - 1
    level_scales = [2.0 ** (top_i - j) for j in range(len(covers))]
    return CoverTree(levels=covers, children=children,
                     level_scales=level_scales, scale=scale, T=T, n=n)


def search(
    tree: CoverTree,
    expensive_fn: DistToMany,
    *,
    eps: float = 0.5,
    k: int = 10,
    quota: int | None = None,
) -> tuple[np.ndarray, np.ndarray, int]:
    """Algorithm 3 with metric D. Returns (top-k ids, D dists, n_D_calls).

    ``expensive_fn(ids)`` returns *raw* D distances; thresholds are applied in
    the scaled units used at build time (Lemma B.4 alignment).
    """
    memo: dict[int, float] = {}
    calls = 0

    def D(ids: np.ndarray) -> np.ndarray:
        nonlocal calls
        new = [int(i) for i in ids if int(i) not in memo]
        if new:
            if quota is not None and calls + len(new) > quota:
                new = new[: max(0, quota - calls)]
            if new:
                vals = np.asarray(expensive_fn(np.asarray(new, np.int64)), np.float64)
                for i, v in zip(new, vals * tree.scale):
                    memo[int(i)] = float(v)
                calls += len(new)
        return np.asarray([memo.get(int(i), np.inf) for i in ids], np.float64)

    Q_i = tree.levels[0]
    _ = D(Q_i)
    for j in range(len(tree.levels) - 1):
        two_i = tree.level_scales[j]
        ch = tree.children[j]
        q_next = set()
        for p in Q_i:
            q_next.update(ch.get(int(p), np.empty(0, np.int64)).tolist())
            q_next.add(int(p))  # self-child: C_i ⊆ C_{i-1}
        Q = np.asarray(sorted(q_next), np.int64)
        dq = D(Q)
        keep = dq <= dq.min() + two_i
        Q_i = Q[keep]
        if dq[keep].min() >= two_i * (1.0 + 1.0 / eps):
            break
        if quota is not None and calls >= quota:
            break

    scored = np.asarray(sorted(memo), np.int64)
    vals = np.asarray([memo[int(i)] for i in scored])
    order = np.argsort(vals, kind="stable")[:k]
    return scored[order], vals[order] / tree.scale, calls


# --------------------------------------------------------------------------
# Flattened layout + the batched engine drive (Algorithm 3 as waves)
# --------------------------------------------------------------------------
class FlatCoverTree(NamedTuple):
    """Engine-indexable cover tree: level-stacked child slabs + raw radii.

    ``children[j, p]`` lists ``{p} ∪ children_j(p)`` (ascending, -1 padded)
    for every ``p ∈ levels[j]``; rows of points absent from level ``j`` are
    all -1 and unreachable. ``radii[j]`` is ``level_scales[j] / scale``, the
    level-j filter radius in *raw* D units, so the engine's f32 pools
    compare against it directly while the NumPy oracle works in scaled f64.
    """
    children: torch.Tensor  # (depth-1, N, R) int32, -1 padded
    radii: np.ndarray       # (depth-1,) float64, raw distance units
    root_ids: np.ndarray    # (E0,) int32 — the top cover, ascending
    scale: float
    T: float
    n: int

    @property
    def depth(self) -> int:
        return self.children.shape[0] + 1

    @property
    def fanout(self) -> int:
        return self.children.shape[2]


class CoverSearchResult(NamedTuple):
    ids: torch.Tensor      # (B, k) int32, -1 padded past the scored count
    dists: torch.Tensor    # (B, k) f32 raw D, +inf on padding
    n_calls: torch.Tensor  # (B,) int32 memoized D evaluations


def flatten(tree: CoverTree, device=None) -> FlatCoverTree:
    """Stack the per-level children into the engine's fixed-shape table,
    built on ``device`` (the card unless ``device="cpu"``)."""
    dev = kernel_backend.resolve_device(device)
    l1 = tree.depth - 1
    slabs, r_max = [], 1
    for ch in tree.children:
        # (parent, child) pairs with each parent beside itself, ascending
        counts = np.diff(ch.indptr)
        par = np.concatenate([np.repeat(ch.parents, counts), ch.parents])
        kid = np.concatenate([ch.kids, ch.parents])
        o = np.lexsort((kid, par))
        par, kid = par[o], kid[o]
        new = np.ones(len(par), bool)
        new[1:] = (par[1:] != par[:-1]) | (kid[1:] != kid[:-1])
        par, kid = par[new], kid[new]
        col = np.arange(len(par)) - np.searchsorted(par, par)
        r_max = max(r_max, int(col.max()) + 1 if len(col) else 1)
        slabs.append((par, col, kid))
    children = torch.full((l1, tree.n, r_max), -1, dtype=_I32, device=dev)
    for j, (par, col, kid) in enumerate(slabs):
        children[j, torch.from_numpy(par).to(dev),
                 torch.from_numpy(col).to(dev)] = torch.from_numpy(
                     kid.astype(np.int32)).to(dev)
    radii = np.asarray(
        [s / tree.scale for s in tree.level_scales[:l1]], np.float64)
    return FlatCoverTree(
        children=children,
        radii=radii,
        root_ids=np.asarray(tree.levels[0], np.int32),
        scale=tree.scale,
        T=tree.T,
        n=tree.n,
    )


def wave_chunk(fanout: int, *, lane_budget: int = 4096) -> int:
    """Frontier chunk width: the largest power of two (≤ 64) whose
    ``chunk × fanout`` wave stays within the lane budget — bounds the
    gather→score working set no matter how wide a level's frontier gets."""
    c = 1
    while c * 2 * fanout <= lane_budget and c * 2 <= 64:
        c *= 2
    return c


def search_batched(
    flat: FlatCoverTree,
    dist_fn_batch: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    query_ctx,
    *,
    eps: float = 0.5,
    k: int = 10,
    quota=None,
    pool_size: int | None = None,
    dedup: str = "auto",
    chunk: int | None = None,
    stepper: beam.ShardedStepper | None = None,
    fuse_levels: bool | None = None,
    device=None,
) -> CoverSearchResult:
    """Algorithm 3 for a whole query batch through ``plan_step`` waves.

    ``dist_fn_batch(query_ctx, ids (B, K)) -> (B, K)`` raw D distances with
    the engine's masking contract (ids < 0 → +inf); ``query_ctx`` is (B, …).
    Per level: :func:`repro_torch.kernels.ops.frontier_count` sizes each
    row's wave (the pool prefix within the previous level's radius),
    ``reset_expanded`` re-opens the rows still alive, and the level's fanout
    is planned in ``chunk``-wide waves against the stacked child table, every
    chunk before any commit. Rows stop independently: the ε test (host f64,
    like the oracle) or the quota (exact wave masking in ``plan_step``)
    freezes a row while its batch-mates descend.

    ``fuse_levels`` chooses a compiled program in the JAX package; here each
    level always runs as that host loop, plans first and commits after, so
    either value gives the same result. With a ``stepper``
    (:class:`repro_torch.core.beam.ShardedStepper`) the bookkeeping runs on
    its corpus mesh, the state on ``stepper.device``, and the scoring stays
    with ``dist_fn_batch``: the result is bit-exact against the unsharded
    drive. Runs on ``device`` (the card unless ``device="cpu"``), of which
    a stepper's mesh must be.
    """
    del fuse_levels  # one drive here; both values mean the same order
    dev = kernel_backend.resolve_device(device)
    n = flat.n
    if stepper is None:
        stepper = beam.ShardedStepper(shards=1, n_points=n, device=dev)
    elif stepper.device.type != dev.type:
        raise ValueError(f"search_batched runs on {dev.type} but the stepper "
                         f"is on {stepper.device}")
    dev = stepper.device
    q_ctx = kernel_backend.as_tensor(query_ctx, dev)
    b = q_ctx.shape[0]
    e0 = int(flat.root_ids.shape[0])

    quota_arr = beam.NO_QUOTA if quota is None else quota
    qmax = beam._static_quota_bound(quota_arr)
    if pool_size is None:
        pool_size = max(k, e0, min(n, qmax))
    if chunk is None:
        chunk = wave_chunk(flat.fanout)
    chunk = max(1, min(chunk, pool_size))  # plan selects E slots from pool P
    dedup, set_cap = beam.resolve_dedup(dedup, None, quota_arr, n,
                                        drive="host")

    quota_j = beam._per_query(quota_arr, b, dev)
    beam_j = beam._per_query(pool_size, b, dev)  # the whole pool is the prefix
    steps_j = beam._per_query(beam.NO_QUOTA, b, dev)
    entries = torch.as_tensor(flat.root_ids, dtype=_I32).to(dev)[None, :]
    state, safe, keep = stepper.init(
        entries.expand(b, e0).contiguous(), quota_j, pool_size=pool_size,
        dedup=dedup, set_capacity=set_cap)
    state = stepper.commit(state, safe, keep, dist_fn_batch(q_ctx, safe))

    children = kernel_backend.as_tensor(flat.children, dev, _I32)
    radii = np.asarray(flat.radii, np.float64)
    alive = np.ones(b, bool)
    for t in range(flat.depth - 1):
        radius = np.inf if t == 0 else float(radii[t - 1])
        ew_t = ops.frontier_count(state.pool_dists, radius).cpu().numpy()
        ew_t = np.where(alive, ew_t, 0).astype(np.int32)
        if not ew_t.any():
            break
        state = stepper.reopen(state, torch.from_numpy(alive).to(dev))
        lev = torch.full((b,), t, dtype=_I32, device=dev)
        planned = []
        remaining = ew_t.copy()
        while remaining.max() > 0:
            ew = np.minimum(remaining, chunk).astype(np.int32)
            state, safe, keep, _ = stepper.plan(
                state, children, quota_j, beam_j, steps_j,
                expand_width=torch.from_numpy(ew).to(dev), expand_cap=chunk,
                level=lev, wave_dedup=False)
            planned.append((safe, keep))
            remaining -= ew
        for safe, keep in planned:
            state = stepper.commit(state, safe, keep,
                                   dist_fn_batch(q_ctx, safe))
        dmin = state.pool_dists[:, 0].cpu().numpy().astype(np.float64)
        alive &= dmin < radii[t] * (1.0 + 1.0 / eps)

    return CoverSearchResult(
        ids=state.pool_ids[:, :k],
        dists=state.pool_dists[:, :k],
        n_calls=state.n_calls,
    )


def search_corpus(
    flat: FlatCoverTree,
    corpus,
    queries,
    *,
    metric: str = "l2",
    eps: float = 0.5,
    k: int = 10,
    quota=None,
    shards: int = 1,
    mesh=None,
    backend=None,
    dedup: str = "auto",
    chunk: int | None = None,
    pool_size: int | None = None,
    device=None,
) -> CoverSearchResult:
    """:func:`search_batched` against an embedding corpus under D.

    Scores every wave through ``beam.fused_dist_fn`` (``ops.gather_score``
    on the whole corpus; the matmul backend builds the corpus-norm view
    once, here). ``shards > 1`` runs the descent's bookkeeping on a
    :class:`repro_torch.core.beam.ShardedStepper` over ``mesh`` (without
    one, ``search_mesh(shards, device=device)``): the dedup bitmap is
    column-sharded, the scoring is not, and the result is bit-exact against
    ``shards=1``.
    """
    dev = kernel_backend.resolve_device(device)
    be = kernel_backend.resolve_backend(backend,
                                        _caller="covertree.search_corpus")
    if not isinstance(corpus, kernel_backend.CorpusView):
        corpus = kernel_backend.as_tensor(corpus, dev)
    fn = beam.fused_dist_fn(corpus, metric, backend=be)
    stepper = beam.ShardedStepper(shards=shards, n_points=flat.n, mesh=mesh,
                                  device=dev)
    return search_batched(
        flat, fn, queries, eps=eps, k=k, quota=quota, pool_size=pool_size,
        dedup=dedup, chunk=chunk, stepper=stepper, device=dev)
