"""Bi-metric serving engine (the port of ``repro.serve.engine``).

* the **cheap tower** embeds the corpus once, at index-build time; the
  index (a Vamana graph or a cover tree) is built on those embeddings
  only;
* the **expensive tower** is the ground-truth metric D: scoring a document
  costs a forward pass, and the quota is an exact budget of them;
* queries run the two-stage search **as a batch**. Stage 1 is one batched
  engine run under d on the device. Stage 2 drives the same core loop
  (``repro_torch.core.beam.plan_step`` / ``commit_scores``) from the host:
  each wave is planned for every query at once, the wave's fresh documents
  are drained through the expensive tower in batches, and the wave is
  scored against the D document cache and committed. A document counts
  against a query's quota the first time that query scores it; the tower
  embeds a document once per engine lifetime.

The request unit is a frozen :class:`SearchRequest`; results are
:class:`SearchResult` (ids, D-dists, :class:`ServeStats`). Two drives:

* **synchronous**: :meth:`BiMetricEngine.query_batch` /
  :meth:`BiMetricEngine.query` run one batch to completion inline;
* **asynchronous**: :meth:`BiMetricEngine.submit` queues one request on a
  priority/deadline heap and returns a :class:`ServeFuture`. One resident
  slot pool, an (S,)-row ``BatchedSearchState``, recycles its rows: a
  finished request frees its slot on the step it goes inactive, and
  admission refills freed rows on every step (``beam.reset_slots``). The
  drive thread overlaps the tower lane's drain with the next admission
  group's cheap embed and stage 1.

Every budget knob is a per-row operand of the core engine and the pools
are streaming exact top-P structures, so a slot row's answer is bit-exact
to the synchronous drive's. On the card that also needs two things of the
device code: a wave is scored by ``l2_topk.gather_score``, whose lane
value depends only on its (query, row) pair, not on the batch's shape; and
a tower's embedding of a row does not depend on its batch-mates.

Device rule: the engine runs on the card unless ``device="cpu"``, and
raises without one. The D document cache is an (N, dim_D) f32 tensor on
that device, next to a host mask of its valid rows (the JAX package keeps
it on the host and copies each wave's rows to the device). Both threads
issue work on the device's default stream.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import heapq
import math
import queue
import threading
import time
import warnings
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import beam, covertree, distances, vamana
from repro_torch.kernels import backend as kernel_backend
from repro_torch.kernels import l2_topk, ops
from repro_torch.models import transformer as T
from repro_torch.serve import faults as serve_faults

_I32 = torch.int32

#: why ``shards > 1`` raises
NO_SHARDS = ("BiMetricEngine at shards > 1 needs beam.ShardedStepper, which "
             "comes with a later slice of the port")


class DeadlineExceeded(Exception):
    """A request's ``deadline_ms`` expired before it resolved.

    Raised into the request's future by the admission layer (expiry while
    queued) or, under ``on_tower_failure="fail"``, by the drive loop's
    mid-flight enforcement (checked on every step and while a tower drain
    is in flight). Under ``on_tower_failure="degrade"`` a mid-flight expiry
    resolves the request with proxy-ranked results (``ServeStats.
    degraded``) instead. Every expiry counts in ``EngineCounters.
    deadline_misses``."""


class TowerFailure(RuntimeError):
    """The expensive-tower lane gave up on a request.

    Raised into affected futures under ``on_tower_failure="fail"`` when the
    lane's bounded retries are exhausted, a failure is non-retryable, the
    drain timed out, or the circuit breaker is open. ``__cause__`` carries
    the original tower exception. Only the affected requests fail."""


class TowerTimeout(TowerFailure):
    """A tower-lane call exceeded ``drain_timeout_ms``. Never retried inline
    (the lane is serial: a retry would queue behind the hung call)."""


class AdmissionFailed(RuntimeError):
    """A request's admission group failed before slot residency: a
    cheap-tower or stage-1 error fails only that group's futures
    (``__cause__`` carries the original exception)."""


class EngineFailure(RuntimeError):
    """Last resort: an unexpected drive-loop error that may have poisoned
    the resident device state. Every resident and staged future fails with
    it (``__cause__`` carries the original) and the state is dropped; the
    next admission starts a fresh one. A CUDA error lands here."""


# --------------------------------------------------------------------------
# legacy call forms: warn once per (function, form), keep the old behaviour
# --------------------------------------------------------------------------
_warned: set[tuple[str, str]] = set()


def _warn_legacy(func: str, form: str) -> None:
    key = (func, form)
    if key in _warned:
        return
    _warned.add(key)
    warnings.warn(
        f"{func}: the legacy {form} call form is deprecated; pass a "
        "repro_torch.serve.SearchRequest instead",
        DeprecationWarning, stacklevel=3)


@dataclasses.dataclass(frozen=True, eq=False)
class SearchRequest:
    """One search request.

    ``tokens`` is the (S,) query token row; ``quota`` the exact expensive-D
    call budget; ``k`` the result size; ``n_seeds`` the stage-1 seed count
    (None = ``max(1, quota // 2)``); ``expand_width`` the stage-2 frontier
    width; ``deadline_ms`` a deadline relative to submit; ``priority``
    orders admission (higher first, FIFO within a priority).
    """

    tokens: np.ndarray
    quota: int
    k: int = 10
    n_seeds: int | None = None
    expand_width: int = 1
    deadline_ms: float | None = None
    priority: int = 0


@dataclasses.dataclass
class ServeStats:
    d_calls: int = 0
    D_calls: int = 0  # expensive-tower document scorings (the budget)
    # forward-pass batches drained during this request's residency (slot
    # drive: shared by co-resident slots; sync drive: the whole batch's,
    # repeated on every row; do not sum)
    tower_batches: int = 0
    # async slot drive only: submit -> admission, admission -> resolution
    queue_ms: float = 0.0
    compute_ms: float = 0.0
    # admission-time snapshots (async slot drive only)
    slot_occupancy: int = 0
    queue_depth: int = 0
    # True when the degradation path resolved the request: ids/dists are
    # the stage-1 proxy ranking under d (or, for the cover tree, the
    # D-scored pool prefix); D_calls counts scorings spent before that
    degraded: bool = False

    @property
    def latency_ms(self) -> float:
        """Submit -> resolve wall clock (``queue_ms + compute_ms``)."""
        return self.queue_ms + self.compute_ms


class SearchResult(NamedTuple):
    """(ids, D-dists, stats); tuple-unpacks like the legacy return."""

    ids: np.ndarray
    dists: np.ndarray
    stats: ServeStats


@dataclasses.dataclass
class EngineCounters:
    """Cumulative admission-layer counters (:meth:`BiMetricEngine.counters`)."""

    submitted: int = 0
    admitted: int = 0
    completed: int = 0
    cancelled: int = 0
    deadline_misses: int = 0
    queue_depth: int = 0
    slot_occupancy: int = 0
    retries: int = 0  # tower-lane retries after transient failures
    tower_failures: int = 0  # failed tower-lane calls (counted pre-retry)
    degraded: int = 0  # requests resolved degraded
    shed: int = 0  # requests failed fast by the tower-down policy "fail"
    breaker_opens: int = 0  # breaker closed -> open transitions


@dataclasses.dataclass
class EmbedTower:
    """An embedding tower: ``model`` (its config is ``model.cfg``), run on
    the model's device under ``torch.inference_mode()``. ``device`` follows
    the port's rule, the card unless ``"cpu"``, and must be the kind of
    device the model is on."""

    model: T.Transformer
    device: str | torch.device | None = None

    def __post_init__(self):
        kind = kernel_backend.resolve_device(self.device).type
        self.device = self.model.embed.device
        if self.device.type != kind:
            raise ValueError(f"EmbedTower: the model is on {self.device}, "
                             f"not on {kind}")

    @property
    def cfg(self) -> T.TransformerConfig:
        return self.model.cfg

    def embed(self, tokens: np.ndarray, batch: int = 64) -> np.ndarray:
        """(N, S) token ids -> (N, embed_dim) f32 unit rows, ``batch`` rows
        a forward pass; the last batch is padded with zero rows, which are
        sliced off."""
        n = tokens.shape[0]
        pad = (-n) % batch
        toks = np.pad(tokens, ((0, pad), (0, 0))) if pad else tokens
        out = []
        with torch.inference_mode():
            for s in range(0, len(toks), batch):
                t = torch.from_numpy(np.ascontiguousarray(toks[s:s + batch]))
                out.append(T.embed_pool(self.model, t.to(self.device)).cpu()
                           .numpy())
        return np.concatenate(out)[:n]


class ServeFuture(concurrent.futures.Future):
    """Result handle of one :meth:`BiMetricEngine.submit` request.

    ``result(timeout)`` blocks for a :class:`SearchResult`. The engine
    resolves exactly once; a caller's ``cancel()`` race is swallowed.
    Requests still queued at :meth:`BiMetricEngine.close` are cancelled; a
    queued deadline expiry raises :class:`DeadlineExceeded`."""

    def _resolve(self, value) -> None:
        try:
            self.set_result(value)
        except concurrent.futures.InvalidStateError:
            pass  # cancelled by the caller; the computed slot is discarded

    def _fail(self, exc: BaseException) -> None:
        try:
            self.set_exception(exc)
        except concurrent.futures.InvalidStateError:
            pass


@dataclasses.dataclass
class _Pending:
    """One queued request: (request, future, submit stamp)."""

    req: SearchRequest
    future: ServeFuture
    t_submit: float


@dataclasses.dataclass
class _Active:
    """Per-slot bookkeeping of an admitted request."""

    pend: _Pending
    t_admit: float
    d_calls: int
    tower0: int  # pool drain counter at admission
    occ_snap: int
    depth_snap: int
    # stage-1 proxy pool row (vamana only): the degraded answer
    proxy_ids: np.ndarray | None = None
    proxy_dists: np.ndarray | None = None


@dataclasses.dataclass
class _Prepared:
    """An admission group after its embeds and stage 1, ready to admit."""

    valid: list  # [(pending, slot)]
    seeds: np.ndarray  # (S, seed_cap)
    quota: np.ndarray  # (S,): admitted rows only, 0 elsewhere
    nseed: np.ndarray  # (S,)
    d_calls: np.ndarray  # (S,)
    q_D: torch.Tensor  # (S, dim_D) f32 on the engine's device
    proxy_ids: np.ndarray | None = None  # (S, P1), vamana only
    proxy_dists: np.ndarray | None = None  # (S, P1)


_STOP = object()  # tower-queue sentinel


def _round_capacity(quota_max: int) -> int:
    """Static sorted-set capacity: the max quota rounded up to a power of
    two, so the shapes both drives share fall into log-many buckets. An
    all-quota-0 wave gets a zero-capacity set."""
    return 0 if quota_max <= 0 else 1 << (int(quota_max) - 1).bit_length()


class _SlotPool:
    """The drive thread's resident slot state (one per started engine).

    Owns the (S,)-row search state, the per-slot host vectors (quota, beam
    width, step cap, k, expand width), the resident expensive query
    embeddings (on the device), and the static caps (pool size P,
    sorted-set capacity C, expand lane cap). Caps only grow, in
    power-of-two buckets; a growth is an exact no-op
    (``beam.grow_state``). Every method runs on the drive thread.
    """

    def __init__(self, eng: "BiMetricEngine"):
        self.eng = eng
        s = eng.slots
        self.S = s
        self.occupied = np.zeros(s, bool)
        self.active_req: list[_Active | None] = [None] * s
        self.quota = np.zeros(s, np.int32)
        self.L = np.ones(s, np.int32)
        self.ms = np.zeros(s, np.int32)
        self.k = np.ones(s, np.int32)
        self.ew = np.ones(s, np.int32)
        self.ct_level = np.zeros(s, np.int32)  # covertree descent position
        self.q_D: torch.Tensor | None = None
        self.state = None
        self.pool_size = 0
        self.dedup: str | None = None
        self.cap: int | None = None
        self.ew_cap = 1
        self.tower_total = 0
        self.prepared: _Prepared | None = None
        # rows whose future already resolved early (mid-flight deadline or
        # degradation while a wave was in flight): freed at the next sweep
        # point, so an in-flight commit never races a re-admission
        self.early = np.zeros(s, bool)
        self._tower_exc: BaseException | None = None

    def _budgets(self):
        """(quota, beam width, step cap) as device vectors."""
        to = self.eng._i32
        return to(self.quota), to(self.L), to(self.ms)

    # ---------------------------------------------------------------- admit
    def prepare(self, group: list[_Pending]) -> _Prepared | None:
        """Stage a group for admission: the expensive query embed on the
        tower lane, the cheap embed and stage 1 here meanwhile. Malformed
        requests fail their own future and are dropped.

        The group is one isolation domain: a cheap-tower or stage-1 error
        fails only this group (:class:`AdmissionFailed`). A query-embed
        failure follows ``on_tower_failure``: ``"degrade"`` resolves the
        group proxy-only. While the lane is open-circuit under
        ``"degrade"`` the group is served proxy-only without a slot."""
        try:
            return self._prepare_inner(group)
        except (KeyboardInterrupt, SystemExit):
            raise
        except BaseException as exc:
            tower = isinstance(exc, TowerFailure)
            shed = 0
            for pend in group:
                if pend.future.done():
                    continue  # failed individually (malformed tokens)
                if tower:
                    # the lane, not the group, failed: keep the class so
                    # callers can tell an outage from bad input
                    err = TowerFailure(
                        "expensive-tower lane unavailable at admission "
                        "(see __cause__)")
                else:
                    err = AdmissionFailed(
                        "admission group failed before slot residency "
                        "(see __cause__)")
                err.__cause__ = exc
                pend.future._fail(err)
                shed += 1
            with self.eng._mu:
                self.eng._counters.shed += shed
            return None

    def _prepare_inner(self, group: list[_Pending]) -> _Prepared | None:
        eng = self.eng
        seq = eng.corpus_tokens.shape[1]
        slots = np.nonzero(~self.occupied)[0][:len(group)]
        tokens = np.zeros((self.S, seq), eng.corpus_tokens.dtype)
        quota_g = np.zeros(self.S, np.int32)
        nseed_g = np.ones(self.S, np.int32)
        valid: list = []
        for pend, slot in zip(group, slots):
            t = np.asarray(pend.req.tokens)
            if t.ndim != 1 or t.shape[0] != seq:
                pend.future._fail(ValueError(
                    f"request tokens shape {t.shape} != ({seq},)"))
                continue
            q = int(pend.req.quota)
            tokens[slot] = t
            quota_g[slot] = q
            ns = pend.req.n_seeds
            nseed_g[slot] = max(1, q // 2) if ns is None else max(1, int(ns))
            valid.append((pend, int(slot)))
        if not valid:
            return None
        blocked = eng._breaker.blocked()
        if eng.index_kind == "covertree":
            # no proxy stage: Algorithm 3 descends from the top cover under
            # D; with the lane open-circuit there is nothing to degrade to
            if blocked:
                raise TowerFailure(
                    "expensive-tower lane is open-circuit and the "
                    "covertree index has no proxy stage to degrade to")
            qfut = eng._tower_submit(("embed_queries", tokens))
            root = np.asarray(eng._flat.root_ids, np.int32)
            seeds = np.full((self.S, root.shape[0]), -1, np.int32)
            for _, slot in valid:
                seeds[slot] = root
            return _Prepared(
                valid=valid, seeds=seeds, quota=quota_g, nseed=nseed_g,
                d_calls=np.zeros(self.S, np.int32),
                q_D=eng._tower_result(qfut, ("embed_queries", tokens),
                                      pool=self))
        if blocked and eng.on_tower_failure == "fail":
            raise TowerFailure(
                "expensive-tower lane is open-circuit "
                f"({eng._breaker.failures} consecutive failures)")
        degrade_only = blocked  # policy "degrade": proxy-only admission
        # the expensive query embed rides the tower lane; the cheap embed
        # and stage 1 run here meanwhile. Fixed (S, seq) shapes with zero
        # pad rows keep per-row embeddings independent of the group
        qfut = (None if degrade_only
                else eng._tower_submit(("embed_queries", tokens)))
        if eng._faults is not None:
            eng._faults.fire("cheap_embed")
        q_d = eng._rows(eng.cheap.embed(tokens))
        width1 = np.where(quota_g > 0, np.maximum(32, nseed_g), 1
                          ).astype(np.int32)
        pool1 = _round_capacity(int(max(width1.max(), nseed_g.max())))
        res1 = eng._stage1(q_d, width=width1, pool=pool1,
                           max_steps=(4 * width1 * (quota_g > 0)
                                      ).astype(np.int32))
        proxy_ids = res1.pool_ids.cpu().numpy()
        proxy_dists = res1.pool_dists.cpu().numpy()
        lane = np.arange(proxy_ids.shape[1], dtype=np.int32)
        seed_cap = _round_capacity(int(nseed_g.max()))
        seeds = np.where(lane[None, :] < nseed_g[:, None], proxy_ids,
                         -1)[:, :seed_cap].astype(np.int32)
        d_calls = res1.n_calls.cpu().numpy()
        if degrade_only:
            self._finish_degraded_group(valid, proxy_ids, proxy_dists,
                                        d_calls)
            return None
        try:
            q_D = eng._tower_result(qfut, ("embed_queries", tokens),
                                    pool=self)
        except (KeyboardInterrupt, SystemExit):
            raise
        except BaseException:
            if eng.on_tower_failure == "degrade":
                # the proxy ranking is in hand: resolve the group degraded
                self._finish_degraded_group(valid, proxy_ids, proxy_dists,
                                            d_calls)
                return None
            raise
        return _Prepared(
            valid=valid, seeds=seeds, quota=quota_g, nseed=nseed_g,
            d_calls=d_calls, q_D=q_D,
            proxy_ids=proxy_ids, proxy_dists=proxy_dists)

    def _finish_degraded_group(self, valid, proxy_ids, proxy_dists,
                               d_calls) -> None:
        """Resolve a staged group proxy-only (stage-1 ranking,
        ``degraded=True``) without a slot: the open-circuit serving mode.
        quota-0 rows resolve empty, as they would fault-free."""
        eng = self.eng
        now = time.monotonic()
        for pend, s in valid:
            kk = int(pend.req.k)
            ids = np.asarray(proxy_ids[s, :kk], np.int64)
            dd = np.asarray(proxy_dists[s, :kk], np.float64)
            if int(pend.req.quota) <= 0:
                ids, dd = ids[:0], dd[:0]
            ok = (ids >= 0) & np.isfinite(dd)
            stats = ServeStats(
                d_calls=int(d_calls[s]), D_calls=0,
                queue_ms=(now - pend.t_submit) * 1e3, compute_ms=0.0,
                degraded=True)
            pend.future._resolve(SearchResult(ids[ok], dd[ok], stats))
        with eng._mu:
            eng._counters.degraded += len(valid)
            eng._counters.completed += len(valid)

    def admit(self, prep: _Prepared) -> None:
        """Recycle the group's slots in the resident state and pay the entry
        wave (``reset_slots`` + entry drain + commit). Rows outside the
        group pass through bit for bit."""
        eng = self.eng
        now = time.monotonic()
        depth = eng._queue_depth()
        for pend, s in prep.valid:
            r = pend.req
            q = int(r.quota)
            ns = int(prep.nseed[s])
            self.quota[s] = q
            if eng.index_kind == "covertree":
                # level descent: the eps rule or the level cap ends a row,
                # both applied by step_ct
                self.L[s] = beam.NO_QUOTA
                self.ms[s] = beam.NO_QUOTA
                self.ct_level[s] = 0
            else:
                self.L[s] = max(int(r.k), min(q, 2 * ns + 8))
                self.ms[s] = 4 * q
            self.k[s] = int(r.k)
            self.ew[s] = max(1, int(r.expand_width))
            self.occupied[s] = True
        for pend, s in prep.valid:
            self.active_req[s] = _Active(
                pend=pend, t_admit=now, d_calls=int(prep.d_calls[s]),
                tower0=self.tower_total,
                occ_snap=int(self.occupied.sum()), depth_snap=depth,
                proxy_ids=(None if prep.proxy_ids is None
                           else prep.proxy_ids[s].copy()),
                proxy_dists=(None if prep.proxy_dists is None
                             else prep.proxy_dists[s].copy()))
        if self.q_D is None or self.q_D.shape[1] != prep.q_D.shape[1]:
            self.q_D = torch.zeros((self.S, prep.q_D.shape[1]),
                                   dtype=torch.float32, device=eng.device)
        rows = torch.as_tensor([s for _, s in prep.valid], device=eng.device)
        self.q_D[rows] = prep.q_D[rows]

        # dedup backend: resolved at the first admission, then only the
        # sorted capacity grows (the backends are bit-exact to each other)
        if self.dedup is None:
            self.dedup, self.cap = beam.resolve_dedup(
                eng.dedup, _round_capacity(int(self.quota.max())),
                self.quota, eng.n, drive="host")
        elif self.dedup == "sorted":
            need = _round_capacity(int(self.quota.max()))
            if self.cap is not None and need > self.cap:
                self.cap = need
                if self.state is not None:
                    self.state = beam.grow_state(self.state,
                                                 set_capacity=need)
        if eng.index_kind == "covertree":
            # pool = the memoized D-call set (bounded by quota and N), never
            # smaller than the root cover or the plan chunk
            p_need = max(_round_capacity(int(max(
                int(self.k.max()), eng._flat.root_ids.shape[0],
                min(eng.n, int(self.quota.max()))))), eng._ct_chunk)
        else:
            p_need = _round_capacity(int(max(self.L.max(), self.k.max())))
        if self.state is None:
            self.pool_size = max(p_need, 1)
            self.state, _, _ = beam.init_state(
                eng._i32(np.full((self.S, 1), -1, np.int32)),
                n_points=eng.n, pool_size=self.pool_size,
                quota=eng._i32(np.zeros(self.S, np.int32)),
                dedup=self.dedup, set_capacity=self.cap)
        elif p_need > self.pool_size:
            self.pool_size = p_need
            self.state = beam.grow_state(self.state, pool_size=p_need)

        reset = np.zeros(self.S, bool)
        for _, s in prep.valid:
            reset[s] = True
        self.state, safe, keep = beam.reset_slots(
            self.state, torch.from_numpy(reset).to(eng.device),
            eng._i32(prep.seeds), eng._i32(self.quota))
        self._drain_and_commit(safe, keep)
        with eng._mu:
            eng._counters.admitted += len(prep.valid)
            eng._counters.slot_occupancy = int(self.occupied.sum())

    # ----------------------------------------------------------------- step
    def _overlap_prepare(self) -> None:
        """Stage the next admission group while the tower drains, at most
        once per drain in flight."""
        eng = self.eng
        if self.prepared is None and not eng._closed:
            free = int((~self.occupied).sum())
            group = eng._pop_group(free) if free else []
            if group:
                self.prepared = self.prepare(group)

    def _drain_wave(self, ids: np.ndarray, *, overlap: bool) -> int | None:
        """One wave drain through the tower lane with bounded retries and
        breaker accounting. Returns the drained batch count, or ``None``
        when the lane gave up, the terminal exception kept for
        :meth:`tower_down`."""
        eng = self.eng
        if eng._breaker.blocked():
            self._tower_exc = TowerFailure(
                "expensive-tower lane is open-circuit "
                f"({eng._breaker.failures} consecutive failures)")
            if overlap:
                self._overlap_prepare()
            return None
        fut = eng._tower_submit(("drain", ids))
        if overlap:
            self._overlap_prepare()
        try:
            return eng._tower_result(fut, ("drain", ids), pool=self)
        except (KeyboardInterrupt, SystemExit):
            raise
        except BaseException as exc:
            self._tower_exc = exc
            return None

    def _score_and_commit(self, safe, keep, *, overlap: bool) -> bool:
        """Drain a planned wave's fresh documents, score it against the D
        cache and commit it. False when the tower lane gave up (the wave is
        not committed; :meth:`tower_down` has resolved the residents)."""
        eng = self.eng
        batches = self._drain_wave(
            safe.cpu().numpy()[keep.cpu().numpy()], overlap=overlap)
        if batches is None:
            self.tower_down()
            return False
        self.tower_total += batches
        self.state = beam.commit_scores(self.state, safe, keep,
                                        eng._wave_dists(self.q_D, safe))
        return True

    def step(self) -> None:
        """One plan/drain/commit wave over every occupied slot; the next
        admission group is staged while the tower drains. A drain the lane
        gives up on resolves the residents per ``on_tower_failure``;
        mid-flight deadline expiries are swept after the commit."""
        eng = self.eng
        if eng.index_kind == "covertree":
            return self.step_ct()
        self.ew_cap = max(self.ew_cap, int(self.ew.max()))
        quota_t, L_t, ms_t = self._budgets()
        self.state, safe, keep, _ = beam.plan_step(
            self.state, eng._adjacency, beam_width=L_t, quota=quota_t,
            max_steps=ms_t, expand_width=eng._i32(self.ew),
            expand_cap=self.ew_cap)
        if self._score_and_commit(safe, keep, overlap=True):
            self.sweep_early()

    def step_ct(self) -> None:
        """One cover-tree level for every slot still descending: size each
        row's frontier, re-open it, plan the level's fanout in chunk-wide
        waves (every plan before any commit), drain and commit each wave,
        then advance the row's level; the eps rule or the level cap freezes
        a finished row (``ms = 0``) for :meth:`resolve_finished`. Each row's
        chunk schedule depends only on its own frontier."""
        eng = self.eng
        radii = eng._ct_radii
        l1 = eng._flat.depth - 1
        chunk = eng._ct_chunk
        stepping = self.occupied & (self.ms > 0)
        if l1 == 0:
            self.ms[stepping] = 0
            return
        quota_t, L_t, ms_t = self._budgets()
        t = self.ct_level.copy()
        radius = np.where(t == 0, np.inf,
                          radii[np.maximum(t - 1, 0)]).astype(np.float32)
        ew_t = ops.frontier_count(
            self.state.pool_dists,
            torch.from_numpy(radius).to(eng.device)).cpu().numpy()
        ew_t = np.where(stepping, ew_t, 0).astype(np.int32)
        self.state = beam.reset_expanded(
            self.state, torch.from_numpy(stepping).to(eng.device))
        lev = eng._i32(np.minimum(t, l1 - 1).astype(np.int32))
        planned = []
        remaining = ew_t.copy()
        while remaining.max() > 0:
            ew = np.minimum(remaining, chunk).astype(np.int32)
            self.state, safe, keep, _ = beam.plan_step(
                self.state, eng._flat.children, beam_width=L_t, quota=quota_t,
                max_steps=ms_t, expand_width=eng._i32(ew), expand_cap=chunk,
                level=lev, wave_dedup=False)
            planned.append((safe, keep))
            remaining -= ew
        for i, (safe, keep) in enumerate(planned):
            if not self._score_and_commit(safe, keep, overlap=(i == 0)):
                return
        pd0 = self.state.pool_dists[:, 0].cpu().numpy().astype(np.float64)
        cont = np.zeros(self.S, bool)
        for s in np.nonzero(stepping)[0]:
            tt = int(t[s])
            if tt >= l1:
                self.ms[s] = 0
                continue
            self.ct_level[s] = tt + 1
            stop = not (pd0[s] < radii[tt] * (1.0 + 1.0 / eng.ct_eps))
            if stop or tt + 1 >= l1:
                self.ms[s] = 0
            else:
                cont[s] = True
        # rows still descending keep an open frontier so active_mask holds
        # them resident when a level admitted nothing fresh; rows resolved
        # early mid-level stay frozen
        cont &= ~self.early
        if cont.any():
            self.state = beam.reset_expanded(
                self.state, torch.from_numpy(cont).to(eng.device))
        self.sweep_early()

    def _drain_and_commit(self, safe, keep) -> bool:
        """Entry-wave drain + commit. False when the tower lane gave up (the
        group is already resolved by :meth:`tower_down`)."""
        if not self._score_and_commit(safe, keep, overlap=False):
            return False
        self.sweep_early()
        return True

    # ------------------------------------------------- degradation/deadlines
    def has_deadlines(self) -> bool:
        """Any resident request with a ``deadline_ms`` (selects the polling
        tower wait)."""
        for s in np.nonzero(self.occupied & ~self.early)[0]:
            a = self.active_req[s]
            if a is not None and a.pend.req.deadline_ms is not None:
                return True
        return False

    def _degraded_rows(self, a: _Active, s: int, ids_all, dd_all):
        """The degraded answer of slot ``s``: the stage-1 proxy pool when
        there is one (vamana), else the slot's D-scored pool prefix."""
        if a.proxy_ids is not None:
            return a.proxy_ids, a.proxy_dists
        return ids_all[s], dd_all[s]

    def _resolve_degraded(self, s: int, ids_row, dd_row, *, now,
                          D_calls: int) -> None:
        """Resolve slot ``s``'s future with ``degraded=True`` stats. Does not
        free the slot: callers mark ``early`` and sweep later."""
        a = self.active_req[s]
        r = a.pend.req
        kk = int(r.k)
        ids = np.asarray(ids_row[:kk], np.int64)
        dd = np.asarray(dd_row[:kk], np.float64)
        ok = (ids >= 0) & np.isfinite(dd)
        stats = ServeStats(
            d_calls=a.d_calls, D_calls=D_calls,
            tower_batches=self.tower_total - a.tower0,
            queue_ms=(a.t_admit - a.pend.t_submit) * 1e3,
            compute_ms=(now - a.t_admit) * 1e3,
            slot_occupancy=a.occ_snap, queue_depth=a.depth_snap,
            degraded=True)
        a.pend.future._resolve(SearchResult(ids[ok], dd[ok], stats))

    def _pools(self):
        """The resident pools and call counts on the host."""
        st = self.state
        return (st.pool_ids.cpu().numpy(), st.pool_dists.cpu().numpy(),
                st.n_calls.cpu().numpy())

    def expire_inflight(self, *, defer_free: bool = False) -> None:
        """Mid-flight deadline enforcement: resolve every resident slot whose
        deadline has passed (degraded under ``"degrade"``,
        :class:`DeadlineExceeded` under ``"fail"``) and close its frontier
        (``beam.early_resolve``). With ``defer_free`` (inside a tower wait,
        a wave in flight) the rows are only marked ``early``; the commit
        path sweeps them afterwards."""
        eng = self.eng
        if self.state is None:
            return
        now = time.monotonic()
        rows = np.zeros(self.S, bool)
        for s in np.nonzero(self.occupied & ~self.early)[0]:
            a = self.active_req[s]
            dl = a.pend.req.deadline_ms
            if dl is None or (now - a.pend.t_submit) * 1e3 <= dl:
                continue
            rows[s] = True
        if not rows.any():
            return
        ids_all, dd_all, calls = self._pools()
        degraded = 0
        failed = 0
        for s in np.nonzero(rows)[0]:
            a = self.active_req[s]
            if eng.on_tower_failure == "degrade":
                ids_row, dd_row = self._degraded_rows(a, s, ids_all, dd_all)
                self._resolve_degraded(s, ids_row, dd_row, now=now,
                                       D_calls=int(calls[s]))
                degraded += 1
            else:
                a.pend.future._fail(DeadlineExceeded(
                    f"deadline {a.pend.req.deadline_ms} ms exceeded "
                    "mid-flight"))
                failed += 1
            self.early[s] = True
        # close the expired rows' frontiers; the other rows are untouched
        self.state = beam.early_resolve(self.state,
                                        torch.from_numpy(rows).to(eng.device))
        with eng._mu:
            eng._counters.deadline_misses += degraded + failed
            eng._counters.degraded += degraded
            eng._counters.completed += degraded
        if not defer_free:
            self.sweep_early()

    def sweep_early(self) -> None:
        """Free the rows resolved early, now that no wave is in flight."""
        if not self.early.any():
            return
        for s in np.nonzero(self.early)[0]:
            self.free_slot(s)
        self.early[:] = False
        with self.eng._mu:
            self.eng._counters.slot_occupancy = int(self.occupied.sum())

    def tower_down(self) -> None:
        """The tower lane gave up on a drain: apply ``on_tower_failure`` to
        every resident request (``"degrade"``: proxy-only answers;
        ``"fail"``: :class:`TowerFailure` chaining the original error). The
        failed wave was never committed, so the resident state stays
        consistent and the engine keeps serving."""
        eng = self.eng
        exc = self._tower_exc or TowerFailure("expensive-tower lane failed")
        self._tower_exc = None
        now = time.monotonic()
        ids_all, dd_all, calls = self._pools()
        degraded = 0
        failed = 0
        rows = self.occupied & ~self.early
        for s in np.nonzero(rows)[0]:
            a = self.active_req[s]
            if eng.on_tower_failure == "degrade":
                ids_row, dd_row = self._degraded_rows(a, s, ids_all, dd_all)
                self._resolve_degraded(s, ids_row, dd_row, now=now,
                                       D_calls=int(calls[s]))
                degraded += 1
            else:
                err = TowerFailure(
                    "expensive-tower drain failed; request resolved "
                    "against policy on_tower_failure='fail' (see __cause__)")
                err.__cause__ = exc
                a.pend.future._fail(err)
                failed += 1
            self.early[s] = True
        self.sweep_early()
        with eng._mu:
            eng._counters.degraded += degraded
            eng._counters.completed += degraded
            eng._counters.shed += failed

    # -------------------------------------------------------------- resolve
    def resolve_finished(self) -> None:
        """Resolve and free every occupied slot that went inactive this step
        (mid-flight: the slot is reusable by the next admission)."""
        eng = self.eng
        if self.state is None or not self.occupied.any():
            return
        quota_t, L_t, ms_t = self._budgets()
        act = beam.active_mask(self.state, beam_width=L_t, quota=quota_t,
                               max_steps=ms_t).cpu().numpy()
        fin = self.occupied & ~act & ~self.early
        if not fin.any():
            return
        ids_all, dd_all, calls = self._pools()
        now = time.monotonic()
        done = 0
        misses = 0
        for s in np.nonzero(fin)[0]:
            a = self.active_req[s]
            r = a.pend.req
            kk = int(r.k)
            row_ids = ids_all[s, :kk].astype(np.int64)
            row_dd = dd_all[s, :kk].astype(np.float64)
            ok = (row_ids >= 0) & np.isfinite(row_dd)
            stats = ServeStats(
                d_calls=a.d_calls, D_calls=int(calls[s]),
                tower_batches=self.tower_total - a.tower0,
                queue_ms=(a.t_admit - a.pend.t_submit) * 1e3,
                compute_ms=(now - a.t_admit) * 1e3,
                slot_occupancy=a.occ_snap, queue_depth=a.depth_snap)
            if (r.deadline_ms is not None
                    and (now - a.pend.t_submit) * 1e3 > r.deadline_ms):
                misses += 1  # admitted late: resolve anyway, count the miss
            a.pend.future._resolve(
                SearchResult(row_ids[ok], row_dd[ok], stats))
            done += 1
            self.free_slot(s)
        with eng._mu:
            eng._counters.completed += done
            eng._counters.deadline_misses += misses
            eng._counters.slot_occupancy = int(self.occupied.sum())

    def free_slot(self, s: int) -> None:
        self.occupied[s] = False
        self.active_req[s] = None
        self.quota[s] = 0
        self.L[s] = 1
        self.ms[s] = 0
        self.k[s] = 1
        self.ew[s] = 1
        self.ct_level[s] = 0

    def fail_all(self, exc: BaseException) -> None:
        """Poisoned resident state (an error outside the tower and admission
        domains, a CUDA error among them): fail every resident and staged
        future with :class:`EngineFailure` chaining the original and drop
        the state; the next admission starts a fresh one."""
        eng = self.eng

        def _wrap() -> EngineFailure:
            err = EngineFailure(
                "engine drive loop failed; resident state dropped "
                "(see __cause__)")
            err.__cause__ = exc
            return err

        if self.prepared is not None:
            for pend, _ in self.prepared.valid:
                if not pend.future.done():
                    pend.future._fail(_wrap())
            self.prepared = None
        for s in np.nonzero(self.occupied)[0]:
            if not self.early[s]:
                self.active_req[s].pend.future._fail(_wrap())
            self.free_slot(s)
        self.early[:] = False
        self._tower_exc = None
        self.state = None
        with eng._mu:
            eng._counters.slot_occupancy = 0


class BiMetricEngine:
    """corpus_tokens: (N, S) int32 document tokens.

    ``index`` is ``"vamana"`` (the DiskANN instantiation: a graph built on
    d, stage 1 under d, stage 2 under D) or ``"covertree"`` (Algorithm 3:
    a cover tree built on d, descended under D; ``n_seeds`` and
    ``expand_width`` are ignored, ``covertree_eps`` / ``covertree_T`` tune
    the descent and the build, and ``rerank_query_batch`` raises).

    ``dedup`` selects stage 2's dedup state: ``"sorted"`` (a (B, C) sorted
    set, C the max quota rounded up to a power of two), ``"bitmap"`` (a
    (B, N) bitmap) or ``"auto"`` (sorted whenever the quota bound is below
    N); both are bit-exact to each other. ``backend`` (``"ref"`` or
    ``"matmul"``) and ``quantize`` pick stage 1's scoring form and
    residency; stage 2 always scores the D cache in ``ref`` form.

    ``slots`` sizes the async drive's slot pool; ``max_wait_ms`` bounds the
    idle drive's poll interval.

    **Fault tolerance** (async path; ``repro_torch.serve``, "Failure
    semantics"): transient tower failures are retried up to
    ``tower_retries`` times with exponential backoff from
    ``retry_backoff_ms``; ``breaker_threshold`` consecutive failures open a
    circuit breaker for ``breaker_cooldown_ms``; ``on_tower_failure``
    (``"fail"`` or ``"degrade"``) decides what a given-up call does to the
    affected requests; ``drain_timeout_ms`` bounds one tower call;
    ``faults`` takes a :class:`~repro_torch.serve.faults.FaultPlan`.

    ``device`` follows the port's rule: the card unless ``"cpu"``, raising
    without one. A tower with a ``device`` attribute must be on the same
    kind of device. ``shards > 1`` raises ``NotImplementedError`` until
    ``beam.ShardedStepper`` is ported.
    """

    def __init__(self, cheap, expensive, corpus_tokens: np.ndarray,
                 index_cfg: vamana.VamanaConfig | None = None,
                 tower_batch: int = 64, shards: int = 1,
                 max_wait_ms: float = 5.0, dedup: str = "auto",
                 backend="ref", quantize: str | None = None,
                 slots: int = 8, index: str = "vamana",
                 covertree_eps: float = 0.5, covertree_T: float = 2.0,
                 on_tower_failure: str = "fail", tower_retries: int = 3,
                 retry_backoff_ms: float = 25.0, breaker_threshold: int = 5,
                 breaker_cooldown_ms: float = 2000.0,
                 drain_timeout_ms: float | None = None,
                 faults: serve_faults.FaultPlan | None = None,
                 device=None):
        if shards > 1:
            raise NotImplementedError(NO_SHARDS)
        dev = kernel_backend.resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        for name, tower in (("cheap", cheap), ("expensive", expensive)):
            td = getattr(tower, "device", None)
            if td is not None and torch.device(td).type != dev.type:
                raise ValueError(f"BiMetricEngine runs on {dev.type} but the "
                                 f"{name} tower is on {td}")
        self.cheap = cheap
        self.expensive = expensive
        self.corpus_tokens = corpus_tokens
        self.n = corpus_tokens.shape[0]
        self.tower_batch = tower_batch
        self.shards = shards
        if dedup not in ("auto", "sorted", "bitmap"):
            raise ValueError(f"unknown dedup backend {dedup!r}")
        self.dedup = dedup
        self.backend = kernel_backend.resolve_backend(
            backend, quantize=quantize, _caller="serve.BiMetricEngine")
        self.slots = int(slots)
        if self.slots < 1:
            raise ValueError("slots must be >= 1")
        self.max_wait = max_wait_ms / 1e3
        if index not in ("vamana", "covertree"):
            raise ValueError(f"unknown index kind {index!r}")
        self.index_kind = index
        self.ct_eps = float(covertree_eps)
        if on_tower_failure not in ("fail", "degrade"):
            raise ValueError(
                f"unknown on_tower_failure policy {on_tower_failure!r}")
        self.on_tower_failure = on_tower_failure
        self.tower_retries = max(0, int(tower_retries))
        self.retry_backoff_s = max(0.0, retry_backoff_ms / 1e3)
        self.drain_timeout_s = (None if drain_timeout_ms is None
                                else max(0.0, drain_timeout_ms / 1e3))
        self._breaker = serve_faults.CircuitBreaker(
            threshold=breaker_threshold,
            cooldown_s=breaker_cooldown_ms / 1e3)
        self._faults = faults
        # --- index build: cheap metric only -------------------------------
        self.emb_d = self._rows(cheap.embed(corpus_tokens))
        if index == "covertree":
            # Algorithm 2 on the cheap embeddings, on the engine's device
            tree = covertree.build(self.emb_d, T=covertree_T, device=dev)
            self._flat = covertree.flatten(tree, device=dev)
            self._ct_radii = np.asarray(self._flat.radii, np.float64)
            self._ct_chunk = covertree.wave_chunk(self._flat.fanout)
            self.index = None
            self._dist_d = None
            self._adjacency = None
        else:
            self._flat = None
            self.index = vamana.build(
                self.emb_d, index_cfg or vamana.VamanaConfig(
                    max_degree=16, l_build=24, pool_size=48,
                    rev_candidates=16), device=dev)
            # stage-1 scoring: the matmul form or a quantized residency
            # builds its view once, here; the graph is built on the exact
            # embeddings either way
            em_d = distances.EmbeddingMetric(self.emb_d)
            if self.backend.matmul or self.backend.quantize is not None:
                self._dist_d = beam.fused_dist_fn(
                    kernel_backend.as_corpus_view(
                        self.emb_d, quantize=self.backend.quantize),
                    em_d.metric, backend=self.backend)
            else:
                self._dist_d = em_d.dists_batch
            self._adjacency = kernel_backend.as_tensor(
                self.index.adjacency, dev, _I32)
        # the expensive-tower document cache: (N, dim_D) f32 rows on the
        # device, valid where the host mask says; written only after a
        # successful forward pass, so a retried drain is idempotent
        self._emb_D: torch.Tensor | None = None
        self._emb_D_valid = np.zeros((self.n,), bool)
        self._cache_lock = threading.Lock()
        # async slot-pool state (threads start on the first submit). _mu
        # guards the admission queue and counters; the lifecycle lock orders
        # start/close against submit. Lock order: lifecycle -> _mu.
        self._lifecycle_lock = threading.Lock()
        self._started = False
        self._closed = False
        self._threads: list[threading.Thread] = []
        self._mu = threading.RLock()
        self._q_cond = threading.Condition(self._mu)
        self._queue: list = []  # heap of (-priority, deadline, seq, _Pending)
        self._seq = 0
        self._counters = EngineCounters()
        self._tower_q: queue.Queue | None = None
        self._pool: _SlotPool | None = None
        self._tower_thread: threading.Thread | None = None

    # ------------------------------------------------------------ internals
    def _rows(self, x: np.ndarray) -> torch.Tensor:
        """Embedding rows from a tower as f32 on the engine's device."""
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
            self.device)

    def _i32(self, a) -> torch.Tensor:
        """A host int vector or matrix as int32 on the engine's device."""
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(
            self.device)

    def _enter_device(self) -> None:
        """Make the engine's card current on this thread (threads start on
        device 0)."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)

    def _stage1(self, q_d: torch.Tensor, *, width, pool: int,
                max_steps) -> beam.SearchResult:
        """Batched cheap-metric greedy search from the medoid (stage 1);
        ``width`` / ``max_steps`` may be per-query (B,) vectors."""
        b = q_d.shape[0]
        entries = torch.full((b, 1), int(self.index.medoid), dtype=_I32,
                             device=self.device)
        return beam.batched_greedy_search(
            self._dist_d, self._adjacency, q_d, entries, n_points=self.n,
            beam_width=width, pool_size=pool, max_steps=max_steps)

    def _drain_tower(self, ids: np.ndarray) -> int:
        """Embed the not-yet-cached docs among ``ids`` through the expensive
        tower into the D cache; returns the forward batches drained.
        Serialized by the cache lock (the lane is single-file; the lock also
        covers synchronous callers running beside the slot drive)."""
        with self._cache_lock:
            ids = np.asarray(ids)
            need = np.unique(
                ids[(ids >= 0) & ~self._emb_D_valid[np.maximum(ids, 0)]])
            if need.size == 0:
                return 0
            embs = self._rows(self.expensive.embed(self.corpus_tokens[need],
                                                   batch=self.tower_batch))
            if self._emb_D is None:
                self._emb_D = torch.zeros((self.n, embs.shape[1]),
                                          dtype=torch.float32,
                                          device=self.device)
            # the rows are written on the default stream before the drain's
            # future resolves, so every wave scored after it reads them
            self._emb_D[torch.from_numpy(need).to(self.device)] = embs
            self._emb_D_valid[need] = True
            return -(-need.size // self.tower_batch)

    def reset_doc_cache(self) -> None:
        """Drop the expensive-tower document cache (benchmark hygiene)."""
        with self._cache_lock:
            self._emb_D = None
            self._emb_D_valid[:] = False

    def _wave_dists(self, q_D: torch.Tensor, safe: torch.Tensor):
        """(B, K) L2 under D of a wave's ids (-1 -> +inf) against the D
        cache, through ``l2_topk.gather_score``: the kernel on the card, its
        plain version (JAX's ``sqrt(sum((doc - q)^2))``) on the CPU. A
        lane's value depends only on its (query, row) pair, so the sync and
        slot drives score a pair alike whatever their batch shapes. Every
        id a wave keeps was drained before this call."""
        emb = self._emb_D
        if emb is None or safe.shape[1] == 0:
            return torch.full(safe.shape, float("inf"), device=safe.device)
        return l2_topk.gather_score(emb, q_D, safe.contiguous(), metric="l2")

    # -------------------------------------------------------- wave coroutine
    def _wave_gen(self, query_tokens: np.ndarray, quota, k, n_seeds,
                  expand_width):
        """Dispatch a synchronous batch to the index kind's coroutine
        (a plain function, so the dispatch runs eagerly)."""
        if self.index_kind == "covertree":
            return self._wave_gen_ct(query_tokens, quota, k)
        return self._wave_gen_vamana(query_tokens, quota, k, n_seeds,
                                     expand_width)

    def _wave_gen_vamana(self, query_tokens: np.ndarray, quota, k, n_seeds,
                         expand_width):
        """The two-stage search of one synchronous batch, as a coroutine.

        Yields tower-lane work, ``("embed_queries", tokens)`` then one
        ``("drain", ids)`` a stage-2 wave, and receives the answer by
        ``send`` (the expensive query embeddings, the drained batch count).
        Returns ``(ids, dists, stats)`` through ``StopIteration.value``.
        The slot drive runs the same per-row math on its resident state.
        """
        b = query_tokens.shape[0]
        quota_np = np.broadcast_to(
            np.asarray(quota, np.int32), (b,)).copy()
        n_seeds_np = (np.maximum(1, quota_np // 2) if n_seeds is None
                      else np.broadcast_to(
                          np.asarray(n_seeds, np.int32), (b,)).copy())
        k_np = np.broadcast_to(np.asarray(k, np.int32), (b,))
        ew_np = np.maximum(1, np.broadcast_to(
            np.asarray(expand_width, np.int32), (b,)))
        ew_cap = int(ew_np.max())

        q_d = self._rows(self.cheap.embed(query_tokens))
        q_D = yield ("embed_queries", query_tokens)

        # stage 1: one batched cheap-metric search, per-query width and
        # steps; quota-0 rows run a width-1, zero-step search
        width1 = np.where(quota_np > 0, np.maximum(32, n_seeds_np), 1
                          ).astype(np.int32)
        pool1 = int(max(width1.max(), n_seeds_np.max()))
        res1 = self._stage1(
            q_d, width=width1, pool=pool1,
            max_steps=(4 * width1 * (quota_np > 0)).astype(np.int32))
        lane = torch.arange(res1.pool_ids.shape[1], device=self.device)
        seeds = torch.where(lane[None, :] < self._i32(n_seeds_np)[:, None],
                            res1.pool_ids, -1)[:, :int(n_seeds_np.max())]
        d_calls = res1.n_calls.cpu().numpy()

        # stage 2: plan on the device, drain the tower for the wave's fresh
        # docs, score and commit on the device
        L = np.maximum(
            k_np, np.minimum(quota_np, 2 * np.maximum(n_seeds_np, 1) + 8))
        P = int(max(L.max(), k_np.max()))
        quota_t = self._i32(quota_np)
        L_t = self._i32(L)
        ms_t = self._i32(4 * quota_np)
        ew_t = self._i32(ew_np)
        tower_batches = 0
        # the dedup backend and its capacity are the slot pool's rule
        dedup, cap = beam.resolve_dedup(
            self.dedup, _round_capacity(int(quota_np.max())), quota_np,
            self.n, drive="host")
        state, safe, keep = beam.init_state(
            seeds.contiguous(), n_points=self.n, pool_size=P, quota=quota_t,
            dedup=dedup, set_capacity=cap)
        while True:
            tower_batches += yield ("drain",
                                    safe.cpu().numpy()[keep.cpu().numpy()])
            state = beam.commit_scores(state, safe, keep,
                                       self._wave_dists(q_D, safe))
            if not bool(beam.active_mask(state, beam_width=L_t,
                                         quota=quota_t,
                                         max_steps=ms_t).any()):
                break
            state, safe, keep, _ = beam.plan_step(
                state, self._adjacency, beam_width=L_t, quota=quota_t,
                max_steps=ms_t, expand_width=ew_t, expand_cap=ew_cap)

        kmax = int(k_np.max())
        ids = state.pool_ids[:, :kmax].cpu().numpy().astype(np.int64)
        dd = state.pool_dists[:, :kmax].cpu().numpy().astype(np.float64)
        D_calls = state.n_calls.cpu().numpy()
        stats = [ServeStats(d_calls=int(d_calls[i]), D_calls=int(D_calls[i]),
                            tower_batches=tower_batches) for i in range(b)]
        return ids, dd, stats

    def _wave_gen_ct(self, query_tokens: np.ndarray, quota, k):
        """Algorithm 3 for one synchronous batch, as a coroutine: the tower
        protocol of the vamana coroutine, the device side of
        ``covertree.search_batched`` (per level: size each row's frontier,
        re-open it, plan every chunk wave, then drain, score and commit
        each)."""
        b = query_tokens.shape[0]
        quota_np = np.broadcast_to(np.asarray(quota, np.int32), (b,)).copy()
        k_np = np.broadcast_to(np.asarray(k, np.int32), (b,))
        q_D = yield ("embed_queries", query_tokens)

        flat = self._flat
        l1 = flat.depth - 1
        chunk = self._ct_chunk
        radii = self._ct_radii
        e0 = int(flat.root_ids.shape[0])
        # the slot pool's p_need, so the two drives share static shapes
        P = max(_round_capacity(int(max(
            int(k_np.max()), e0, min(self.n, int(quota_np.max()))))), chunk)
        dedup, cap = beam.resolve_dedup(
            self.dedup, _round_capacity(int(quota_np.max())), quota_np,
            self.n, drive="host")
        quota_t = self._i32(quota_np)
        L_t = self._i32(np.full((b,), beam.NO_QUOTA, np.int32))
        ms_t = L_t
        entries = self._i32(np.broadcast_to(
            np.asarray(flat.root_ids, np.int32)[None, :], (b, e0)))
        state, safe, keep = beam.init_state(
            entries, n_points=self.n, pool_size=P, quota=quota_t,
            dedup=dedup, set_capacity=cap)
        tower_batches = 0

        def _commit(s, sf, kp):
            nonlocal tower_batches
            tower_batches += yield ("drain",
                                    sf.cpu().numpy()[kp.cpu().numpy()])
            return beam.commit_scores(s, sf, kp, self._wave_dists(q_D, sf))

        state = yield from _commit(state, safe, keep)
        alive = np.ones(b, bool)
        for t in range(l1):
            radius = np.inf if t == 0 else float(radii[t - 1])
            ew_t = ops.frontier_count(state.pool_dists, radius).cpu().numpy()
            ew_t = np.where(alive, ew_t, 0).astype(np.int32)
            if not ew_t.any():
                break
            state = beam.reset_expanded(
                state, torch.from_numpy(alive).to(self.device))
            lev = torch.full((b,), t, dtype=_I32, device=self.device)
            planned = []
            remaining = ew_t.copy()
            while remaining.max() > 0:
                ew = np.minimum(remaining, chunk).astype(np.int32)
                state, safe, keep, _ = beam.plan_step(
                    state, self._flat.children, beam_width=L_t, quota=quota_t,
                    max_steps=ms_t, expand_width=self._i32(ew),
                    expand_cap=chunk, level=lev, wave_dedup=False)
                planned.append((safe, keep))
                remaining -= ew
            for safe, keep in planned:
                state = yield from _commit(state, safe, keep)
            dmin = state.pool_dists[:, 0].cpu().numpy().astype(np.float64)
            alive &= dmin < radii[t] * (1.0 + 1.0 / self.ct_eps)

        kmax = int(k_np.max())
        ids = state.pool_ids[:, :kmax].cpu().numpy().astype(np.int64)
        dd = state.pool_dists[:, :kmax].cpu().numpy().astype(np.float64)
        D_calls = state.n_calls.cpu().numpy()
        stats = [ServeStats(d_calls=0, D_calls=int(D_calls[i]),
                            tower_batches=tower_batches) for i in range(b)]
        return ids, dd, stats

    def _service_tower(self, item):
        """Run one tower-lane work item (the expensive tower's passes)."""
        kind, payload = item
        if self._faults is not None:
            # injection precedes the real work and the cache write, so a
            # retried drain recomputes from the same cache state
            self._faults.fire(kind)
        if kind == "embed_queries":
            # query embeddings are not charged to the quota: the budget
            # counts document scorings (the paper's cost model)
            return self._rows(self.expensive.embed(payload))
        return self._drain_tower(payload)  # "drain"

    def _drive_sync(self, gen):
        """Run a wave coroutine to completion, servicing tower work inline."""
        try:
            item = next(gen)
            while True:
                item = gen.send(self._service_tower(item))
        except StopIteration as stop:
            return stop.value

    # ---------------------------------------------------------------- query
    @staticmethod
    def _is_request_batch(obj) -> bool:
        return (isinstance(obj, (list, tuple)) and len(obj) > 0
                and all(isinstance(r, SearchRequest) for r in obj))

    def query_batch(self, requests=None, *, quota=None,
                    k: int = 10, n_seeds=None, expand_width=1):
        """Two-stage bi-metric search of a batch of requests, inline.

        Native form: a list of :class:`SearchRequest` -> a list of
        :class:`SearchResult`. Legacy form (deprecated, warns once): a
        (B, S) token array with ``quota`` / ``k`` / ``n_seeds`` /
        ``expand_width`` scalars or (B,) vectors -> ``(ids (B, k), D-dists
        (B, k), [ServeStats])`` padded with id -1 / dist +inf.
        """
        if self._is_request_batch(requests):
            reqs = list(requests)
            tokens = np.stack([np.asarray(r.tokens) for r in reqs])
            quota_v = np.array([int(r.quota) for r in reqs], np.int32)
            k_v = np.array([int(r.k) for r in reqs], np.int32)
            nseed_v = np.array(
                [max(1, int(r.quota) // 2) if r.n_seeds is None
                 else max(1, int(r.n_seeds)) for r in reqs], np.int32)
            ew_v = np.array(
                [max(1, int(r.expand_width)) for r in reqs], np.int32)
            ids, dd, stats = self._drive_sync(
                self._wave_gen(tokens, quota_v, k_v, nseed_v, ew_v))
            out = []
            for i, r in enumerate(reqs):
                row_ids, row_dd = ids[i, :r.k], dd[i, :r.k]
                ok = (row_ids >= 0) & np.isfinite(row_dd)
                out.append(SearchResult(row_ids[ok], row_dd[ok], stats[i]))
            return out
        if isinstance(requests, SearchRequest):
            raise TypeError(
                "query_batch takes a list of SearchRequest; use "
                "query(request) for a single one")
        if quota is None:
            raise TypeError("legacy query_batch(tokens, ...) needs quota=")
        _warn_legacy("query_batch", "query_batch(tokens, quota=...)")
        return self._drive_sync(self._wave_gen(
            np.asarray(requests), quota, k, n_seeds, expand_width))

    def query(self, request=None, *, quota: int | None = None, k: int = 10,
              n_seeds: int | None = None) -> SearchResult:
        """One request, inline: ``query(SearchRequest)``; legacy form
        (deprecated, warns once) ``query(tokens, quota=...)``."""
        if isinstance(request, SearchRequest):
            return self.query_batch([request])[0]
        if quota is None:
            raise TypeError("legacy query(tokens, ...) needs quota=")
        _warn_legacy("query", "query(tokens, quota=...)")
        ids, dd, stats = self._drive_sync(self._wave_gen(
            np.asarray(request)[None], int(quota), int(k), n_seeds, 1))
        ok = (ids[0] >= 0) & np.isfinite(dd[0])
        return SearchResult(ids[0][ok], dd[0][ok], stats[0])

    # ------------------------------------------------------- async slot pool
    def submit(self, request=None, *, quota: int | None = None,
               k: int = 10, n_seeds: int | None = None,
               expand_width: int = 1, deadline_ms: float | None = None,
               priority: int = 0) -> ServeFuture:
        """Queue one request for the slot pool -> a :class:`ServeFuture` of
        a :class:`SearchResult`. Native form ``submit(SearchRequest)``;
        legacy form (deprecated, warns once) ``submit(tokens, quota=...)``.
        Starts the drive threads on first use; raises ``RuntimeError``
        after :meth:`close`."""
        if not isinstance(request, SearchRequest):
            if quota is None:
                raise TypeError("legacy submit(tokens, ...) needs quota=")
            _warn_legacy("submit", "submit(tokens, quota=...)")
            request = SearchRequest(
                tokens=np.asarray(request), quota=int(quota), k=int(k),
                n_seeds=n_seeds, expand_width=expand_width,
                deadline_ms=deadline_ms, priority=priority)
        fut = ServeFuture()
        now = time.monotonic()
        pend = _Pending(req=request, future=fut, t_submit=now)
        deadline = (math.inf if request.deadline_ms is None
                    else now + request.deadline_ms / 1e3)
        # enqueue under the lifecycle lock: close() flips _closed under it
        # before it cancels the queue, so no request lands behind the sweep
        with self._lifecycle_lock:
            self._ensure_started_locked()
            with self._q_cond:
                self._seq += 1
                heapq.heappush(
                    self._queue,
                    (-int(request.priority), deadline, self._seq, pend))
                self._counters.submitted += 1
                self._counters.queue_depth = len(self._queue)
                self._q_cond.notify_all()
        return fut

    def counters(self) -> EngineCounters:
        """Snapshot of the admission-layer counters (cumulative;
        ``queue_depth`` / ``slot_occupancy`` are instantaneous)."""
        with self._mu:
            snap = dataclasses.replace(self._counters)
        snap.breaker_opens = self._breaker.opens
        return snap

    def health(self) -> dict:
        """Breaker state, degradation mode, queue and slot pressure and the
        counters, as a dict; safe to call from any thread."""
        snap = self.counters()
        state = self._breaker.state
        return {
            "breaker_state": state,
            "consecutive_tower_failures": self._breaker.failures,
            "breaker_opens": self._breaker.opens,
            "degraded_mode": (state != "closed"
                              and self.on_tower_failure == "degrade"),
            "on_tower_failure": self.on_tower_failure,
            "queue_depth": snap.queue_depth,
            "slot_occupancy": snap.slot_occupancy,
            "started": self._started,
            "closed": self._closed,
            "counters": dataclasses.asdict(snap),
        }

    def close(self, timeout: float | None = 60.0) -> None:
        """Stop the slot pool. Admitted (or staged) requests still resolve;
        requests still queued are cancelled (``CancelledError``). Raises
        ``RuntimeError`` if the threads fail to join within ``timeout``.
        Idempotent; ``submit`` raises afterwards."""
        with self._lifecycle_lock:
            already = self._closed
            self._closed = True
            started = self._started
            dropped: list[_Pending] = []
            if not already and started:
                with self._q_cond:
                    while self._queue:
                        dropped.append(heapq.heappop(self._queue)[-1])
                    self._counters.queue_depth = 0
                    self._counters.cancelled += len(dropped)
                    self._q_cond.notify_all()
        if already or not started:
            return
        for pend in dropped:  # outside the locks: cancel runs callbacks
            pend.future.cancel()
        for t in self._threads:
            t.join(timeout)
        stuck = [t.name for t in self._threads if t.is_alive()]
        if stuck:
            raise RuntimeError(
                f"engine threads failed to join within timeout={timeout}: "
                f"{stuck} (daemon threads: they die with the process, but "
                "resident requests may be unresolved)")

    def _ensure_started_locked(self) -> None:
        """Start the drive and tower threads on first use; the caller holds
        ``_lifecycle_lock``."""
        if self._closed:
            raise RuntimeError("engine slot pool is closed")
        if self._started:
            return
        self._tower_q = queue.Queue()
        self._pool = _SlotPool(self)
        self._threads = [
            threading.Thread(target=loop, daemon=True, name=name)
            for name, loop in (("serve-drive", self._drive_loop),
                               ("serve-tower", self._tower_loop))]
        self._tower_thread = self._threads[1]
        for t in self._threads:
            t.start()
        self._started = True

    # ----------------------------------------------------- admission helpers
    def _queue_depth(self) -> int:
        with self._mu:
            return len(self._queue)

    def _pop_group(self, n: int) -> list[_Pending]:
        """Pop up to ``n`` requests in (priority, deadline, FIFO) order;
        entries whose deadline already passed fail here, never admitted."""
        now = time.monotonic()
        group: list[_Pending] = []
        expired: list[_Pending] = []
        with self._q_cond:
            while self._queue and len(group) < n:
                _, deadline, _, pend = heapq.heappop(self._queue)
                if deadline < now:
                    expired.append(pend)
                else:
                    group.append(pend)
            self._counters.queue_depth = len(self._queue)
            self._counters.deadline_misses += len(expired)
        for pend in expired:  # outside the lock: _fail runs callbacks
            pend.future._fail(DeadlineExceeded(
                f"deadline_ms={pend.req.deadline_ms} expired while queued"))
        return group

    def _expire_queued(self) -> None:
        """Fail every queued request whose deadline has passed (every
        drive-loop iteration, so expiry does not wait for a free slot)."""
        now = time.monotonic()
        expired: list[_Pending] = []
        with self._q_cond:
            if not self._queue:
                return
            alive = [e for e in self._queue if e[1] >= now]
            if len(alive) == len(self._queue):
                return
            expired = [e[-1] for e in self._queue if e[1] < now]
            heapq.heapify(alive)
            self._queue = alive
            self._counters.queue_depth = len(alive)
            self._counters.deadline_misses += len(expired)
        for pend in expired:
            pend.future._fail(DeadlineExceeded(
                f"deadline_ms={pend.req.deadline_ms} expired while queued"))

    def _tower_submit(self, item) -> concurrent.futures.Future:
        fut: concurrent.futures.Future = concurrent.futures.Future()
        if self._tower_thread is not None and not self._tower_thread.is_alive():
            # the lane thread died (an interrupt escaped it): fail fast
            fut.set_exception(TowerFailure(
                "expensive-tower lane thread is dead"))
            return fut
        self._tower_q.put((item, fut))
        return fut

    def _await_tower(self, fut: concurrent.futures.Future, pool):
        """Wait for one tower-lane future: a blocking wait without resident
        deadlines or a ``drain_timeout_ms``, else a 20 ms poll that expires
        mid-flight deadlines during the call (``defer_free``) and turns a
        hung call into :class:`TowerTimeout`."""
        if self.drain_timeout_s is None and (
                pool is None or not pool.has_deadlines()):
            return fut.result()
        t0 = time.monotonic()
        while True:
            try:
                return fut.result(timeout=0.02)
            except concurrent.futures.TimeoutError:
                if pool is not None:
                    pool.expire_inflight(defer_free=True)
                if (self.drain_timeout_s is not None
                        and time.monotonic() - t0 > self.drain_timeout_s):
                    raise TowerTimeout(
                        f"tower call exceeded drain_timeout_ms="
                        f"{self.drain_timeout_s * 1e3:g}") from None

    def _tower_result(self, fut: concurrent.futures.Future, item,
                      pool=None):
        """Await a tower-lane call with bounded exponential-backoff retries
        and breaker accounting. Only transient failures retry (an exception
        with a falsy ``transient``, or a :class:`TowerTimeout`, goes
        straight to the caller); the terminal exception propagates to the
        isolation boundary that decides whom it fails."""
        attempts = 0
        while True:
            try:
                out = self._await_tower(fut, pool)
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException as exc:
                attempts += 1
                self._breaker.on_failure()
                with self._mu:
                    self._counters.tower_failures += 1
                retryable = (getattr(exc, "transient", True)
                             and not isinstance(exc, TowerTimeout))
                if (not retryable or attempts > self.tower_retries
                        or self._breaker.blocked()):
                    raise
                with self._mu:
                    self._counters.retries += 1
                time.sleep(self.retry_backoff_s * (2 ** (attempts - 1)))
                fut = self._tower_submit(item)
                continue
            self._breaker.on_success()
            return out

    # ----------------------------------------------------------- drive loops
    def _drive_loop(self) -> None:
        pool = self._pool
        try:
            self._enter_device()
            while True:
                try:
                    self._expire_queued()
                    pool.expire_inflight()
                    if pool.prepared is not None:
                        prep, pool.prepared = pool.prepared, None
                        pool.admit(prep)
                        pool.resolve_finished()
                        continue
                    free = int((~pool.occupied).sum())
                    if free:
                        group = self._pop_group(free)
                        if group:
                            pool.prepared = pool.prepare(group)
                            continue
                    if pool.occupied.any():
                        pool.step()
                        pool.resolve_finished()
                        continue
                except (KeyboardInterrupt, SystemExit) as exc:
                    # fail the resident futures, then honour the interrupt:
                    # never swallow it into a served error
                    pool.fail_all(exc)
                    raise
                except BaseException as exc:
                    # last resort: tower and admission failures are isolated
                    # upstream; anything here poisoned the resident state
                    pool.fail_all(exc)
                    continue
                # idle: no occupied slots, nothing admittable right now
                with self._q_cond:
                    if self._queue:
                        continue
                    if self._closed:
                        break
                    self._q_cond.wait(max(self.max_wait, 0.05))
        finally:
            self._tower_q.put(_STOP)

    def _tower_loop(self) -> None:
        self._enter_device()
        while True:
            got = self._tower_q.get()
            if got is _STOP:
                break
            item, fut = got
            try:
                fut.set_result(self._service_tower(item))
            except (KeyboardInterrupt, SystemExit) as exc:
                fut.set_exception(exc)  # surface on drive, then honour it
                raise
            except BaseException as exc:  # surfaced on the drive thread
                fut.set_exception(exc)

    # --------------------------------------------------------------- rerank
    def _embed_queries(self, query_tokens: np.ndarray):
        """(B, S) tokens -> cheap (B, dim_d) and expensive (B, dim_D) rows
        on the device (not charged to the quota)."""
        return (self._rows(self.cheap.embed(query_tokens)),
                self._rows(self.expensive.embed(query_tokens)))

    def rerank_query_batch(self, query_tokens: np.ndarray, *, quota: int,
                           k: int = 10,
                           ) -> tuple[np.ndarray, np.ndarray, list[ServeStats]]:
        """"Bi-metric (baseline)": top-quota by d, embed all with D, rerank
        (scored against the D cache like a stage-2 wave)."""
        if self.index_kind == "covertree":
            raise ValueError(
                "the rerank baseline needs the vamana proxy graph; "
                "build the engine with index='vamana'")
        b = query_tokens.shape[0]
        q_d, q_D = self._embed_queries(query_tokens)
        width = max(32, quota)
        res1 = self._stage1(q_d, width=width, pool=max(width, quota),
                            max_steps=8 * width)
        cand = res1.pool_ids[:, :quota].contiguous()
        cand_np = cand.cpu().numpy()
        tower_batches = self._drain_tower(cand_np)
        dd = self._wave_dists(q_D, cand)  # +inf where cand < 0
        order = torch.argsort(dd, dim=1, stable=True)[:, :k]
        d_calls = res1.n_calls.cpu().numpy()
        n_D = (cand_np >= 0).sum(1)
        stats = [ServeStats(d_calls=int(d_calls[i]), D_calls=int(n_D[i]),
                            tower_batches=tower_batches) for i in range(b)]
        return (cand.gather(1, order).cpu().numpy().astype(np.int64),
                dd.gather(1, order).cpu().numpy(), stats)

    def rerank_query(self, query_tokens: np.ndarray, *, quota: int,
                     k: int = 10) -> tuple[np.ndarray, np.ndarray, ServeStats]:
        """One query (S,) tokens through the rerank baseline."""
        ids, dd, stats = self.rerank_query_batch(query_tokens[None],
                                                 quota=quota, k=k)
        ok = (ids[0] >= 0) & np.isfinite(dd[0])
        return ids[0][ok], dd[0][ok], stats[0]
