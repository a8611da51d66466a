"""The port's serving failure semantics, on the CPU.

Ported from ``tests/test_serve_faults.py``, its ``slow`` sharded chaos case
in process on ``["cpu"] * S`` meshes. Seeded fault injection
(``repro_torch.serve.faults.FaultPlan``) drives the tower lane through
transient faults, hangs, outages and interrupts, and pins the contract of
``repro_torch.serve``'s "Failure semantics": transient drain faults leave
every answer bit-exact, a given-up tower call fails or degrades only the
affected requests, the breaker opens and heals, deadlines fire queued and
mid-flight, ``close(timeout=)`` raises on a stuck drive, and submit racing
close never strands a future. Every wait has a timeout of its own.
"""
import concurrent.futures as cf
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core import beam, distances
from repro_torch.distributed.sharding import search_mesh
from repro_torch.launch import serve as launch_serve
from repro_torch.models import transformer as T
from repro_torch.serve import (AdmissionFailed, BiMetricEngine,
                               DeadlineExceeded, EmbedTower, EngineFailure,
                               FaultPlan, FaultSpec, InjectedFault,
                               SearchRequest, TowerFailure)
from repro_torch.serve.faults import CircuitBreaker

CPU = "cpu"
WAIT = 60  # seconds, every future and join


@pytest.fixture(scope="module")
def engine_parts():
    exp_cfg = T.TransformerConfig(
        name="exp-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=128, vocab=512, embed_dim=32)
    cheap = EmbedTower(T.init_params(0, launch_serve.cheap_smoke(),
                                     device=CPU), device=CPU)
    expensive = EmbedTower(T.init_params(1, exp_cfg, device=CPU), device=CPU)
    corpus = np.random.default_rng(0).integers(0, 512, (96, 10),
                                               dtype=np.int32)
    return cheap, expensive, corpus


def _engine(parts, expensive=None, **kw):
    cheap, exp, corpus = parts
    return BiMetricEngine(cheap, expensive or exp, corpus, device=CPU, **kw)


def _reqs(corpus, rows=(3, 40, 77, 12, 55, 9, 61), quota=15, k=5, **kw):
    return [SearchRequest(tokens=corpus[r], quota=quota, k=k, **kw)
            for r in rows]


def _wait_for(pred, timeout=WAIT, what="condition"):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return
        time.sleep(0.005)
    raise AssertionError(f"timed out waiting for {what}")


def _assert_same(got, want):
    assert np.array_equal(got.ids, want.ids)
    np.testing.assert_array_equal(got.dists, want.dists)
    assert got.stats.D_calls == want.stats.D_calls


# ----------------------------------------------------------- fault plan unit
def test_fault_plan_deterministic_and_healable():
    a = FaultPlan(seed=7, drain=FaultSpec(rate=0.4))
    b = FaultPlan(seed=7, drain=FaultSpec(rate=0.4))

    def trace(plan, n=40):
        out = []
        for _ in range(n):
            try:
                plan.fire("drain")
                out.append(0)
            except InjectedFault:
                out.append(1)
        return out

    ta, tb = trace(a), trace(b)
    assert ta == tb and sum(ta) > 0
    for i, hit in enumerate(ta[:-1]):  # a forced success after each firing
        if hit:
            assert ta[i + 1] == 0
    a.fire("embed_queries")  # no spec: never faults
    with pytest.raises(ValueError):
        FaultPlan(drain=FaultSpec(), bogus=FaultSpec())
    p = FaultPlan(seed=1, drain=FaultSpec(rate=1.0, mode="persistent"))
    for _ in range(3):
        with pytest.raises(InjectedFault):
            p.fire("drain")
    assert p.fired("drain") == 1 and p.calls("drain") == 3
    p.heal()
    for _ in range(3):
        p.fire("drain")


def test_circuit_breaker_states():
    t = [0.0]
    br = CircuitBreaker(threshold=3, cooldown_s=10.0, clock=lambda: t[0])
    assert br.state == "closed" and not br.blocked()
    br.on_failure()
    br.on_failure()
    assert br.state == "closed"
    br.on_failure()
    assert br.state == "open" and br.blocked() and br.opens == 1
    t[0] = 11.0
    assert br.state == "half_open" and not br.blocked()
    br.on_failure()  # a failed probe re-arms the cooldown
    assert br.blocked() and br.opens == 1
    t[0] = 22.0
    br.on_success()
    assert br.state == "closed" and br.failures == 0


def test_early_resolve_closes_rows_only():
    rng = np.random.default_rng(3)
    corpus = torch.from_numpy(rng.normal(size=(64, 8)).astype(np.float32))
    em = distances.EmbeddingMetric(corpus)
    q = torch.from_numpy(rng.normal(size=(4, 8)).astype(np.float32))
    quota = torch.tensor([12] * 4, dtype=torch.int32)
    state, safe, keep = beam.init_state(
        torch.tensor([[1, 5, 9]] * 4, dtype=torch.int32), n_points=64,
        pool_size=8, quota=quota, dedup="bitmap")
    state = beam.commit_scores(state, safe, keep, em.dists_batch(q, safe))
    assert bool(beam.active_mask(state, beam_width=8, quota=quota,
                                 max_steps=40).all())
    closed = beam.early_resolve(state, torch.tensor([False, True, False,
                                                     True]))
    act = beam.active_mask(closed, beam_width=8, quota=quota, max_steps=40)
    assert act.tolist() == [True, False, True, False]
    for leaf_new, leaf_old in zip(closed, state):
        assert torch.equal(leaf_new[[0, 2]], leaf_old[[0, 2]])
    assert torch.equal(closed.pool_ids, state.pool_ids)


# --------------------------------------------------------- transient chaos
def test_transient_drain_faults_bit_exact(engine_parts):
    """10% transient drain and query-embed faults: every request resolves
    bit-exact to the fault-free run; retries are counted."""
    corpus = engine_parts[2]
    ref = _engine(engine_parts).query_batch(_reqs(corpus))
    plan = FaultPlan(seed=11, drain=FaultSpec(rate=0.10),
                     embed_queries=FaultSpec(rate=0.10))
    eng = _engine(engine_parts, slots=3, faults=plan, retry_backoff_ms=1.0)
    futs = [eng.submit(r) for r in _reqs(corpus)]
    for f, want in zip(futs, ref):
        got = f.result(timeout=WAIT)
        _assert_same(got, want)
        assert not got.stats.degraded
    c = eng.counters()
    assert c.completed == len(futs) and c.degraded == 0
    fired = plan.fired("drain") + plan.fired("embed_queries")
    assert fired > 0 and c.retries >= fired and c.tower_failures >= fired
    assert eng.health()["breaker_state"] == "closed"
    eng.close(timeout=WAIT)


@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_chaos_parity(engine_parts, shards):
    """``tests/test_serve_faults.py::test_sharded_chaos_parity``: 10 %
    transient drain faults at S shards over an uneven N = 97 corpus; every
    request resolves bit for bit as the fault-free unsharded sync drive,
    not degraded, and the fault stream fired and was retried."""
    cheap, expensive, _ = engine_parts
    corpus = np.random.default_rng(0).integers(0, 512, (97, 10),
                                               dtype=np.int32)
    parts = (cheap, expensive, corpus)
    reqs = [SearchRequest(tokens=corpus[r], quota=q, k=5)
            for r, q in zip((3, 40, 77, 12, 55), (6, 15, 9, 11, 15))]
    ref = _engine(parts).query_batch(reqs)
    plan = FaultPlan(seed=13, drain=FaultSpec(rate=0.10))
    eng = _engine(parts, shards=shards, slots=2, faults=plan,
                  retry_backoff_ms=1.0,
                  mesh=search_mesh(shards, devices=[CPU] * shards))
    for f, want in zip([eng.submit(r) for r in reqs], ref):
        got = f.result(timeout=WAIT)
        _assert_same(got, want)
        assert got.stats.d_calls == want.stats.d_calls
        assert not got.stats.degraded
    c = eng.counters()
    assert c.completed == len(reqs) and c.slot_occupancy == 0
    assert plan.fired("drain") > 0 and c.retries >= plan.fired("drain")
    eng.close(timeout=WAIT)


@pytest.mark.parametrize("site", ["drain", "embed_queries"])
def test_sharded_degrade_parity(engine_parts, site):
    """A persistent drain or query-embed outage under 'degrade' at S = 2
    over N = 97: every answer is degraded, and it is the unsharded
    engine's degraded answer under the same plan bit for bit (the stage-1
    proxy ranking, here from ``sharded_greedy_search``'s pools)."""
    cheap, expensive, _ = engine_parts
    corpus = np.random.default_rng(0).integers(0, 512, (97, 10),
                                               dtype=np.int32)
    parts = (cheap, expensive, corpus)
    reqs = _reqs(corpus, rows=(3, 40, 77), quota=12)

    def answers(**kw):
        plan = FaultPlan(seed=4, **{site: FaultSpec(rate=1.0,
                                                    mode="persistent")})
        eng = _engine(parts, slots=2, faults=plan, on_tower_failure="degrade",
                      retry_backoff_ms=1.0, **kw)
        got = [f.result(timeout=WAIT) for f in [eng.submit(r) for r in reqs]]
        eng.close(timeout=WAIT)
        assert plan.fired(site) > 0
        return got

    ref = answers()
    for got, want in zip(answers(shards=2,
                                 mesh=search_mesh(2, devices=[CPU] * 2)),
                         ref):
        assert got.stats.degraded and want.stats.degraded
        assert got.ids.size > 0
        _assert_same(got, want)
        assert got.stats.d_calls == want.stats.d_calls


def test_persistent_drain_fail_policy_isolates(engine_parts):
    """A drain outage under 'fail': affected requests fail with
    TowerFailure chaining the injected fault; healed, the engine serves
    bit-exact again."""
    corpus = engine_parts[2]
    plan = FaultPlan(seed=2, drain=FaultSpec(rate=1.0, mode="persistent"))
    eng = _engine(engine_parts, slots=2, faults=plan, retry_backoff_ms=1.0,
                  breaker_threshold=1, breaker_cooldown_ms=50.0)
    futs = [eng.submit(r) for r in _reqs(corpus, rows=(3, 40, 77))]
    errs = []
    for f in futs:
        with pytest.raises(TowerFailure) as ei:
            f.result(timeout=WAIT)
        errs.append(ei.value)
    assert any(isinstance(e.__cause__, InjectedFault)
               or isinstance(getattr(e.__cause__, "__cause__", None),
                             InjectedFault) for e in errs)
    assert eng.counters().breaker_opens >= 1
    plan.heal()
    time.sleep(0.1)  # past the cooldown: the next tower call is the probe
    req = SearchRequest(tokens=corpus[12], quota=15, k=5)
    got = eng.submit(req).result(timeout=WAIT)
    _assert_same(got, _engine(engine_parts).query(req))
    assert not got.stats.degraded
    assert eng.health()["breaker_state"] == "closed"
    eng.close(timeout=WAIT)


def test_persistent_drain_degrade_policy(engine_parts):
    """A drain and query-embed outage under 'degrade': every request
    resolves with its stage-1 proxy ranking, degraded=True; the breaker
    opens; healed, the engine serves full answers again."""
    corpus = engine_parts[2]
    plan = FaultPlan(seed=2, drain=FaultSpec(rate=1.0, mode="persistent"),
                     embed_queries=FaultSpec(rate=1.0, mode="persistent"))
    eng = _engine(engine_parts, slots=2, faults=plan,
                  on_tower_failure="degrade", retry_backoff_ms=1.0,
                  breaker_threshold=2, breaker_cooldown_ms=200.0)
    futs = [eng.submit(r) for r in _reqs(corpus)]
    for f in futs:
        got = f.result(timeout=WAIT)
        assert got.stats.degraded
        assert 0 < got.ids.size <= 5
        assert np.all((got.ids >= 0) & (got.ids < corpus.shape[0]))
        assert np.all(np.diff(got.dists) >= 0)
    c = eng.counters()
    assert c.degraded == len(futs) and c.completed == len(futs)
    assert c.breaker_opens >= 1
    h = eng.health()
    assert h["degraded_mode"] and h["breaker_state"] in ("open", "half_open")
    plan.heal()
    time.sleep(0.25)
    req = SearchRequest(tokens=corpus[12], quota=15, k=5)
    got = eng.submit(req).result(timeout=WAIT)
    assert not got.stats.degraded
    _assert_same(got, _engine(engine_parts).query(req))
    eng.close(timeout=WAIT)


def test_degraded_answer_is_the_proxy_ranking(engine_parts):
    """A degraded answer equals that request's stage-1 pool prefix: the
    cheap metric's ranking from the medoid, as the sync stage 1 gives it."""
    cheap, _, corpus = engine_parts
    plan = FaultPlan(seed=0, drain=FaultSpec(rate=1.0, mode="persistent"))
    eng = _engine(engine_parts, slots=2, faults=plan,
                  on_tower_failure="degrade", retry_backoff_ms=1.0)
    reqs = _reqs(corpus, rows=(3, 40), quota=12)
    got = [f.result(timeout=WAIT) for f in [eng.submit(r) for r in reqs]]
    eng.close(timeout=WAIT)
    q_d = eng._rows(cheap.embed(np.stack([r.tokens for r in reqs])))
    width = np.full(2, 32, np.int32)
    res1 = eng._stage1(q_d, width=width, pool=32, max_steps=4 * width)
    for i, g in enumerate(got):
        assert g.stats.degraded
        np.testing.assert_array_equal(g.ids, res1.pool_ids[i, :5].numpy())
        np.testing.assert_array_equal(
            g.dists, res1.pool_dists[i, :5].numpy().astype(np.float64))


def test_cheap_embed_failure_fails_group_only(engine_parts):
    """A cheap-tower failure while staging a group fails that group with
    AdmissionFailed; the engine keeps serving."""
    corpus = engine_parts[2]
    plan = FaultPlan(seed=0,
                     cheap_embed=FaultSpec(rate=1.0, mode="persistent"))
    eng = _engine(engine_parts, slots=2, faults=plan)
    req = SearchRequest(tokens=corpus[3], quota=12, k=5)
    with pytest.raises(AdmissionFailed) as ei:
        eng.submit(req).result(timeout=WAIT)
    assert isinstance(ei.value.__cause__, InjectedFault)
    assert eng.counters().shed >= 1
    plan.heal()
    got = eng.submit(req).result(timeout=WAIT)
    _assert_same(got, _engine(engine_parts).query(req))
    eng.close(timeout=WAIT)


def test_embed_queries_failure_degrades_group(engine_parts):
    """A query-embed outage under 'degrade' resolves the staged group
    proxy-only (no slot, D_calls == 0)."""
    corpus = engine_parts[2]
    plan = FaultPlan(
        seed=0, embed_queries=FaultSpec(rate=1.0, mode="persistent"))
    eng = _engine(engine_parts, slots=2, faults=plan,
                  on_tower_failure="degrade", retry_backoff_ms=1.0)
    got = eng.submit(SearchRequest(tokens=corpus[40], quota=12, k=5)
                     ).result(timeout=WAIT)
    assert got.stats.degraded and got.stats.D_calls == 0
    assert got.ids.size > 0
    eng.close(timeout=WAIT)


# ------------------------------------------------------------------ deadlines
def test_queued_expiry_stays_deadline_exceeded(engine_parts):
    """Queued expiry is DeadlineExceeded even under 'degrade'."""
    corpus = engine_parts[2]
    plan = FaultPlan(seed=0, drain=FaultSpec(rate=1.0, mode="hang",
                                             hang_s=0.4))
    eng = _engine(engine_parts, slots=1, faults=plan,
                  on_tower_failure="degrade")
    fa = eng.submit(SearchRequest(tokens=corpus[3], quota=12, k=5))
    _wait_for(lambda: eng.counters().queue_depth == 0
              and eng.counters().submitted == 1, what="A popped")
    fb = eng.submit(SearchRequest(tokens=corpus[40], quota=8, k=5,
                                  deadline_ms=30.0))
    with pytest.raises(DeadlineExceeded):
        fb.result(timeout=WAIT)
    fa.result(timeout=WAIT)
    assert eng.counters().deadline_misses == 1
    eng.close(timeout=WAIT)


@pytest.mark.parametrize("policy", ["degrade", "fail"])
def test_midflight_deadline_during_hung_drain(engine_parts, policy):
    """A deadline expiring while a drain hangs resolves the slot
    mid-flight (its proxy ranking under 'degrade', DeadlineExceeded under
    'fail') before the drain returns; the deadline-free slot-mate stays
    bit-exact to the fault-free run."""
    corpus = engine_parts[2]
    req_a = SearchRequest(tokens=corpus[3], quota=24, k=5)
    ref = _engine(engine_parts).query(req_a)
    # the entry drain (call 0) is clean; every later drain hangs 0.3 s
    plan = FaultPlan(seed=0, drain=FaultSpec(rate=1.0, mode="hang",
                                             hang_s=0.3, after=1))
    eng = _engine(engine_parts, slots=2, faults=plan,
                  on_tower_failure=policy)
    fa = eng.submit(req_a)
    fb = eng.submit(SearchRequest(tokens=corpus[40], quota=24, k=5,
                                  deadline_ms=120.0))
    if policy == "degrade":
        rb = fb.result(timeout=WAIT)
        assert rb.stats.degraded and rb.ids.size > 0
    else:
        with pytest.raises(DeadlineExceeded):
            fb.result(timeout=WAIT)
    ra = fa.result(timeout=WAIT)
    assert not ra.stats.degraded
    _assert_same(ra, ref)
    c = eng.counters()
    assert c.deadline_misses >= 1
    assert c.degraded >= (policy == "degrade")
    eng.close(timeout=WAIT)


def test_deadline_priority_refill_order(engine_parts):
    """At equal priority the sooner deadline takes a freed slot first;
    answers match the fault-free solo runs and no miss is counted."""
    corpus = engine_parts[2]
    plan = FaultPlan(seed=0, drain=FaultSpec(rate=1.0, mode="hang",
                                             hang_s=0.1))
    eng = _engine(engine_parts, slots=1, faults=plan)
    order: list[str] = []
    fa = eng.submit(SearchRequest(tokens=corpus[3], quota=12, k=5))
    _wait_for(lambda: eng.counters().queue_depth == 0
              and eng.counters().submitted == 1, what="A popped")
    req_b = SearchRequest(tokens=corpus[40], quota=8, k=5,
                          deadline_ms=60_000.0)
    req_c = SearchRequest(tokens=corpus[77], quota=8, k=5,
                          deadline_ms=30_000.0)
    fb, fc = eng.submit(req_b), eng.submit(req_c)
    fb.add_done_callback(lambda f: order.append("B"))
    fc.add_done_callback(lambda f: order.append("C"))
    rb, rc = fb.result(timeout=WAIT), fc.result(timeout=WAIT)
    fa.result(timeout=WAIT)
    eng.close(timeout=WAIT)
    assert order == ["C", "B"]
    solo = _engine(engine_parts)
    _assert_same(rb, solo.query(req_b))
    _assert_same(rc, solo.query(req_c))
    assert eng.counters().deadline_misses == 0


def test_drain_timeout_gives_up_without_retry(engine_parts):
    """A drain hung past drain_timeout_ms becomes TowerTimeout: the
    resident request fails, nothing is retried, the engine serves on."""
    corpus = engine_parts[2]
    plan = FaultPlan(seed=0, drain=FaultSpec(rate=1.0, mode="hang",
                                             hang_s=0.6))
    eng = _engine(engine_parts, slots=1, faults=plan, drain_timeout_ms=150.0)
    f = eng.submit(SearchRequest(tokens=corpus[3], quota=12, k=5))
    with pytest.raises(TowerFailure):  # TowerTimeout is a TowerFailure
        f.result(timeout=WAIT)
    assert eng.counters().retries == 0
    plan.heal()
    time.sleep(0.7)  # the hung call finishes in the lane's background
    req = SearchRequest(tokens=corpus[40], quota=12, k=5)
    got = eng.submit(req).result(timeout=WAIT)
    _assert_same(got, _engine(engine_parts).query(req))
    eng.close(timeout=WAIT)


# ------------------------------------------------------- interrupts + close
@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_keyboard_interrupt_reraised_not_served(engine_parts):
    """A KeyboardInterrupt in the tower lane fails the resident futures
    (EngineFailure chaining it) and ends both loops; it is never served."""
    corpus = engine_parts[2]
    plan = FaultPlan(seed=0, drain=FaultSpec(rate=1.0, mode="persistent",
                                             exc=KeyboardInterrupt))
    eng = _engine(engine_parts, slots=1, faults=plan)
    f = eng.submit(SearchRequest(tokens=corpus[3], quota=12, k=5))
    with pytest.raises(EngineFailure) as ei:
        f.result(timeout=WAIT)
    assert isinstance(ei.value.__cause__, KeyboardInterrupt)
    _wait_for(lambda: all(not t.is_alive() for t in eng._threads),
              what="loops honoured the interrupt")
    eng.close(timeout=5.0)


class _GatedTower:
    """Expensive-tower wrapper whose forward passes block on an Event."""

    def __init__(self, inner: EmbedTower):
        self.inner = inner
        self.gate = threading.Event()
        self.gate.set()

    def embed(self, tokens, batch: int = 64):
        assert self.gate.wait(WAIT), "gate never released"
        return self.inner.embed(tokens, batch)


def test_close_raises_on_stuck_drive(engine_parts):
    """close(timeout=) with the drive wedged in a tower call raises instead
    of returning with a live thread."""
    corpus = engine_parts[2]
    gated = _GatedTower(engine_parts[1])
    eng = _engine(engine_parts, expensive=gated, slots=1)
    gated.gate.clear()
    f = eng.submit(SearchRequest(tokens=corpus[3], quota=12, k=5))
    _wait_for(lambda: eng.counters().queue_depth == 0
              and eng.counters().submitted == 1, what="A popped")
    with pytest.raises(RuntimeError, match="failed to join"):
        eng.close(timeout=0.3)
    gated.gate.set()
    f.result(timeout=WAIT)
    _wait_for(lambda: all(not t.is_alive() for t in eng._threads),
              what="threads drained after release")
    eng.close(timeout=WAIT)


def test_concurrent_submit_close_stress(engine_parts):
    """Threads submitting while close() runs: every future resolves, is
    cancelled, or its submit raised; nothing hangs or is dropped."""
    corpus = engine_parts[2]
    eng = _engine(engine_parts, slots=2)
    futs: list = []
    mu = threading.Lock()
    stop = threading.Event()

    def pump(seed):
        rng = np.random.default_rng(seed)
        while not stop.is_set():
            try:
                f = eng.submit(SearchRequest(
                    tokens=corpus[int(rng.integers(0, corpus.shape[0]))],
                    quota=6, k=3))
                with mu:
                    futs.append(f)
            except RuntimeError:
                return
            time.sleep(0.001)

    threads = [threading.Thread(target=pump, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    _wait_for(lambda: len(futs) >= 6, what="submissions flowing")
    eng.close(timeout=WAIT)
    stop.set()
    for t in threads:
        t.join(timeout=WAIT)
        assert not t.is_alive()
    resolved = cancelled = 0
    for f in futs:
        try:
            assert f.result(timeout=WAIT).stats.D_calls >= 0
            resolved += 1
        except cf.CancelledError:
            cancelled += 1
    assert resolved + cancelled == len(futs)
    c = eng.counters()
    assert c.completed == resolved and c.cancelled == cancelled
    with pytest.raises(RuntimeError):
        eng.submit(SearchRequest(tokens=corpus[0], quota=5))
