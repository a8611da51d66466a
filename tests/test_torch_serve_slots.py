"""The port's async slot drive against its own sync drive, on the CPU.

Ported from ``tests/test_serve_slots.py`` and ``tests/test_serve_async.py``
(their ``slow`` sharded cases wait for ``beam.ShardedStepper``): the slot
pool's answers are bit-exact to ``query_batch`` of the same requests
(vamana and cover tree), and its admission semantics hold: priority slot
reuse, deadline expiry while queued, backpressure, quota-0 rows,
``close()`` cancelling queued requests only, the ``max_wait`` flush, a
malformed request failing alone. Then the slot primitives of
``core/beam.py``, the engine's device rule and the serving launcher.

The towers are the port's own smoke towers drawn from seeds on the CPU. A
``_GatedTower`` holds the drive thread inside a tower call, so a test can
build a deterministic admitted-vs-queued split before releasing it. Every
wait has a timeout of its own.
"""
import concurrent.futures as cf
import threading
import time
import warnings

import numpy as np
import pytest
import torch

from repro_torch.core import beam, distances
from repro_torch.launch import serve as launch_serve
from repro_torch.models import transformer as T
from repro_torch.serve import (BiMetricEngine, DeadlineExceeded, EmbedTower,
                               SearchRequest)

CPU = "cpu"
WAIT = 60  # seconds, every future and join


def _exp_smoke():
    return T.TransformerConfig(
        name="exp-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=128, vocab=512, embed_dim=32)


@pytest.fixture(scope="module")
def engine_parts():
    cheap = EmbedTower(T.init_params(0, launch_serve.cheap_smoke(),
                                     device=CPU), device=CPU)
    expensive = EmbedTower(T.init_params(1, _exp_smoke(), device=CPU),
                           device=CPU)
    corpus = np.random.default_rng(0).integers(0, 512, (96, 10),
                                               dtype=np.int32)
    return cheap, expensive, corpus


def _engine(parts, expensive=None, **kw):
    cheap, exp, corpus = parts
    return BiMetricEngine(cheap, expensive or exp, corpus, device=CPU, **kw)


class _GatedTower:
    """Expensive-tower wrapper whose forward passes block on an Event."""

    def __init__(self, inner: EmbedTower):
        self.inner = inner
        self.gate = threading.Event()
        self.gate.set()

    def embed(self, tokens, batch: int = 64):
        assert self.gate.wait(WAIT), "gate never released"
        return self.inner.embed(tokens, batch)


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
    assert got.stats.d_calls == want.stats.d_calls


def _mixed(corpus):
    rows = [3, 40, 77, 12, 55, 9, 61]
    return [
        SearchRequest(tokens=corpus[rows[0]], quota=24, k=10),
        SearchRequest(tokens=corpus[rows[1]], quota=8, k=5),
        SearchRequest(tokens=corpus[rows[2]], quota=16, k=10, n_seeds=4),
        SearchRequest(tokens=corpus[rows[3]], quota=24, k=10,
                      expand_width=2),
        SearchRequest(tokens=corpus[rows[4]], quota=0, k=5),
        SearchRequest(tokens=corpus[rows[5]], quota=12, k=3),
        SearchRequest(tokens=corpus[rows[6]], quota=24, k=10),
    ]


# ---------------------------------------------------------------- admission
@pytest.mark.parametrize("index", ["vamana", "covertree"])
def test_slot_drive_parity_mixed_requests(engine_parts, index):
    """More requests than slots, mixed quota/k/n_seeds/expand_width: every
    slot-drive answer is bit-exact to query_batch, latency split sane."""
    eng = _engine(engine_parts, slots=3, index=index)
    reqs = _mixed(engine_parts[2])
    ref = eng.query_batch(reqs)
    futs = [eng.submit(r) for r in reqs]
    for i, f in enumerate(futs):
        got = f.result(timeout=WAIT)
        _assert_same(got, ref[i])
        assert got.stats.D_calls <= reqs[i].quota
        assert got.stats.queue_ms >= 0.0 and got.stats.compute_ms > 0.0
        assert got.stats.latency_ms == pytest.approx(
            got.stats.queue_ms + got.stats.compute_ms)
    c = eng.counters()
    assert c.submitted == c.completed == 7
    assert c.queue_depth == 0 and c.slot_occupancy == 0
    eng.close(timeout=WAIT)


def test_slot_freed_midflight_reused_by_priority(engine_parts):
    """With one slot busy, a higher-priority late arrival takes the freed
    slot before an earlier low-priority request."""
    cheap, expensive, corpus = engine_parts
    gated = _GatedTower(expensive)
    eng = _engine(engine_parts, expensive=gated, slots=1)
    order: list[str] = []
    gated.gate.clear()
    fa = eng.submit(SearchRequest(tokens=corpus[3], quota=12, k=5))
    _wait_for(lambda: eng.counters().queue_depth == 0
              and eng.counters().submitted == 1, what="A popped")
    fc = eng.submit(SearchRequest(tokens=corpus[40], quota=8, k=5,
                                  priority=0))
    fb = eng.submit(SearchRequest(tokens=corpus[77], quota=8, k=5,
                                  priority=5))
    fb.add_done_callback(lambda f: order.append("B"))
    fc.add_done_callback(lambda f: order.append("C"))
    gated.gate.set()
    rb, rc = fb.result(timeout=WAIT), fc.result(timeout=WAIT)
    fa.result(timeout=WAIT)
    eng.close(timeout=WAIT)
    assert order == ["B", "C"]
    ref = _engine(engine_parts)
    _assert_same(rb, ref.query(SearchRequest(tokens=corpus[77], quota=8,
                                             k=5)))
    _assert_same(rc, ref.query(SearchRequest(tokens=corpus[40], quota=8,
                                             k=5)))


def test_deadline_expiry_while_queued(engine_parts):
    """A queued request whose deadline passes before a slot frees fails
    with DeadlineExceeded; the request in flight is untouched."""
    cheap, expensive, corpus = engine_parts
    gated = _GatedTower(expensive)
    eng = _engine(engine_parts, expensive=gated, slots=1)
    gated.gate.clear()
    fa = eng.submit(SearchRequest(tokens=corpus[3], quota=12, k=5))
    _wait_for(lambda: eng.counters().queue_depth == 0
              and eng.counters().submitted == 1, what="A popped")
    fb = eng.submit(SearchRequest(tokens=corpus[40], quota=8, k=5,
                                  deadline_ms=30.0))
    time.sleep(0.1)  # B expires while the only slot is busy
    gated.gate.set()
    with pytest.raises(DeadlineExceeded):
        fb.result(timeout=WAIT)
    ra = fa.result(timeout=WAIT)
    assert 0 < ra.stats.D_calls <= 12
    assert eng.counters().deadline_misses == 1
    eng.close(timeout=WAIT)


def test_all_slots_busy_backpressure(engine_parts):
    """Arrivals beyond the slot count queue (observable depth), then drain;
    admission snapshots record the pressure."""
    cheap, expensive, corpus = engine_parts
    gated = _GatedTower(expensive)
    eng = _engine(engine_parts, expensive=gated, slots=2)
    gated.gate.clear()
    first = [eng.submit(SearchRequest(tokens=corpus[r], quota=24, k=5))
             for r in (3, 40)]
    _wait_for(lambda: eng.counters().queue_depth < 2
              and eng.counters().submitted == 2, what="first group popped")
    base = eng.counters().queue_depth
    rest = [eng.submit(SearchRequest(tokens=corpus[r], quota=24, k=5))
            for r in (77, 12, 55, 9)]
    assert eng.counters().queue_depth == base + 4
    gated.gate.set()
    results = [f.result(timeout=WAIT) for f in first + rest]
    assert all(0 < r.stats.D_calls <= 24 for r in results)
    assert any(r.stats.queue_depth > 0 for r in results)
    assert any(r.stats.slot_occupancy == 2 for r in results)
    c = eng.counters()
    assert c.completed == 6 and c.queue_depth == 0 and c.slot_occupancy == 0
    eng.close(timeout=WAIT)


def test_quota_zero_padding_slots(engine_parts):
    """quota-0 requests ride the pool as padding rows: no D call, empty
    results, no effect on a real slot-mate."""
    corpus = engine_parts[2]
    eng = _engine(engine_parts, slots=4)
    real = SearchRequest(tokens=corpus[3], quota=15, k=5)
    futs = [eng.submit(SearchRequest(tokens=corpus[r], quota=0, k=5))
            for r in (40, 77)]
    freal = eng.submit(real)
    for f in futs:
        r = f.result(timeout=WAIT)
        assert r.ids.size == 0 and r.stats.D_calls == 0
    got = freal.result(timeout=WAIT)
    eng.close(timeout=WAIT)
    _assert_same(got, _engine(engine_parts).query(real))


def test_close_cancels_queued_not_admitted(engine_parts):
    """close() cancels the queued request at once (CancelledError) while
    the admitted one still resolves."""
    cheap, expensive, corpus = engine_parts
    gated = _GatedTower(expensive)
    eng = _engine(engine_parts, expensive=gated, slots=1)
    gated.gate.clear()
    fa = eng.submit(SearchRequest(tokens=corpus[3], quota=12, k=5))
    _wait_for(lambda: eng.counters().queue_depth == 0
              and eng.counters().submitted == 1, what="A popped")
    fb = eng.submit(SearchRequest(tokens=corpus[40], quota=8, k=5))
    closer = threading.Thread(target=eng.close, kwargs=dict(timeout=WAIT))
    closer.start()
    with pytest.raises(cf.CancelledError):
        fb.result(timeout=WAIT)
    assert not fa.done()
    assert eng.counters().cancelled == 1
    gated.gate.set()
    closer.join(timeout=WAIT)
    assert not closer.is_alive()
    ra = fa.result(timeout=WAIT)
    assert 0 < ra.stats.D_calls <= 12
    with pytest.raises(RuntimeError):
        eng.submit(SearchRequest(tokens=corpus[3], quota=5))


def test_async_bit_exact_vs_query_batch(engine_parts):
    """Legacy forms: one wave of submits == query_batch, bit for bit."""
    from repro_torch.serve import engine as E

    eng = _engine(engine_parts, slots=3, max_wait_ms=500.0)
    qs = eng.corpus_tokens[[3, 40, 77]].copy()
    for form in (("query_batch", "query_batch(tokens, quota=...)"),
                 ("submit", "submit(tokens, quota=...)")):
        E._warned.discard(form)  # each warns once a process
    with pytest.warns(DeprecationWarning):
        ids_b, dd_b, st_b = eng.query_batch(qs, quota=15, k=5)
    with pytest.warns(DeprecationWarning):
        futs = [eng.submit(qs[i], quota=15, k=5) for i in range(3)]
    for i, f in enumerate(futs):
        ids1, dd1, s1 = f.result(timeout=WAIT)
        ok = (ids_b[i] >= 0) & np.isfinite(dd_b[i])
        assert np.array_equal(ids1, ids_b[i][ok])
        np.testing.assert_array_equal(dd1, dd_b[i][ok])
        assert (s1.D_calls, s1.d_calls) == (st_b[i].D_calls, st_b[i].d_calls)
    eng.close(timeout=WAIT)


def test_mixed_quotas_in_one_wave(engine_parts):
    """Mixed budgets share a wave with exact per-query accounting, equal to
    the sync batch and to each request alone."""
    corpus = engine_parts[2]
    eng = _engine(engine_parts, slots=3, max_wait_ms=500.0)
    reqs = [SearchRequest(tokens=corpus[r], quota=q, k=5)
            for r, q in ((3, 4), (40, 15), (77, 9))]
    ref = eng.query_batch(reqs)
    assert [r.stats.D_calls for r in ref] == [4, 15, 9]
    futs = [eng.submit(r) for r in reqs]
    for f, want in zip(futs, ref):
        _assert_same(f.result(timeout=WAIT), want)
    eng.close(timeout=WAIT)
    solo = _engine(engine_parts)
    for r, want in zip(reqs, ref):
        _assert_same(solo.query(r), want)


def test_max_wait_flush_partial_wave(engine_parts):
    """A lone request does not wait for a full pool: it is admitted with
    padding rows, which never change its answer."""
    corpus = engine_parts[2]
    eng = _engine(engine_parts, slots=8, max_wait_ms=5.0)
    req = SearchRequest(tokens=corpus[7], quota=12, k=5)
    got = eng.submit(req).result(timeout=WAIT)
    eng.close(timeout=WAIT)
    _assert_same(got, _engine(engine_parts).query(req))


def test_single_request_latency_parity(engine_parts):
    """submit() of one request answers what query() answers, within a wide
    wall-clock envelope of it."""
    corpus = engine_parts[2]
    eng = _engine(engine_parts, slots=4, max_wait_ms=5.0)
    req = SearchRequest(tokens=corpus[11], quota=12, k=5)
    eng.submit(req).result(timeout=WAIT)  # warm both drives
    t0 = time.perf_counter()
    r_async = eng.submit(req).result(timeout=WAIT)
    t_async = time.perf_counter() - t0
    t0 = time.perf_counter()
    r_sync = eng.query(req)
    t_sync = time.perf_counter() - t0
    eng.close(timeout=WAIT)
    _assert_same(r_async, r_sync)
    assert t_async < 20 * max(t_sync, 1e-3) + 1.0


def test_clean_shutdown_with_inflight_requests(engine_parts):
    """close() settles every future: admitted ones resolve, queued ones are
    cancelled; close is idempotent and submit afterwards raises."""
    corpus = engine_parts[2]
    eng = _engine(engine_parts, slots=2, max_wait_ms=1.0)
    futs = [eng.submit(SearchRequest(tokens=corpus[r], quota=10, k=5))
            for r in (3, 9, 40, 55, 77)]
    eng.close(timeout=WAIT)
    resolved = cancelled = 0
    for f in futs:
        try:
            assert f.result(timeout=WAIT).stats.D_calls <= 10
            resolved += 1
        except cf.CancelledError:
            cancelled += 1
    assert resolved + cancelled == 5
    assert eng.counters().cancelled == cancelled
    eng.close(timeout=WAIT)
    with pytest.raises(RuntimeError):
        eng.submit(SearchRequest(tokens=corpus[0], quota=5))


def test_malformed_request_fails_only_itself(engine_parts):
    """A bad request (wrong token length) fails its own future; the drive
    survives and later requests serve."""
    corpus = engine_parts[2]
    eng = _engine(engine_parts, slots=2, max_wait_ms=1.0)
    bad = eng.submit(SearchRequest(tokens=np.zeros((7,), np.int32), quota=5))
    with pytest.raises(ValueError):
        bad.result(timeout=WAIT)
    got = eng.submit(SearchRequest(tokens=corpus[3], quota=10, k=5)
                     ).result(timeout=WAIT)
    assert got.stats.D_calls <= 10 and got.ids.size > 0
    eng.close(timeout=WAIT)


def test_quota_zero_async(engine_parts):
    eng = _engine(engine_parts, slots=2, max_wait_ms=1.0)
    got = eng.submit(SearchRequest(tokens=engine_parts[2][0], quota=0, k=5)
                     ).result(timeout=WAIT)
    eng.close(timeout=WAIT)
    assert got.ids.size == 0 and got.stats.D_calls == 0


def test_cache_saves_tower_batches_not_accounting(engine_parts):
    """A repeated query spends the same D_calls; the tower is not re-run."""
    eng = _engine(engine_parts)
    req = SearchRequest(tokens=engine_parts[2][7], quota=12, k=5)
    r1, r2 = eng.query(req), eng.query(req)
    _assert_same(r2, r1)
    assert r1.stats.tower_batches > 0 and r2.stats.tower_batches == 0
    eng.reset_doc_cache()
    r3 = eng.query(req)
    _assert_same(r3, r1)
    assert r3.stats.tower_batches == r1.stats.tower_batches


def test_legacy_forms_warn_once(engine_parts):
    from repro_torch.serve import engine as E

    eng = _engine(engine_parts)
    E._warned.discard(("query", "query(tokens, quota=...)"))
    with pytest.warns(DeprecationWarning, match="SearchRequest"):
        ids, dd, st = eng.query(engine_parts[2][5], quota=6, k=5)
    assert st.D_calls <= 6
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        eng.query(engine_parts[2][5], quota=6, k=5)  # warned already


@pytest.mark.parametrize("knob", [dict(backend="matmul"),
                                  dict(quantize="int8")])
def test_engine_stage1_knobs(engine_parts, knob):
    """Stage 1's scoring form and residency: the matmul form answers the
    ref engine's ids and accounting (JAX's ``test_engine_backend_knob``);
    an int8 stage 1 keeps stage 2 exact (its dists are D's, bit for bit
    against the D cache) and the slot drive bit-exact to the sync one."""
    corpus = engine_parts[2]
    reqs = [SearchRequest(tokens=corpus[r], quota=12, k=5) for r in (5, 33)]
    ref = _engine(engine_parts).query_batch(reqs)
    eng = _engine(engine_parts, slots=2, **knob)
    got = eng.query_batch(reqs)
    if "backend" in knob:
        for g, w in zip(got, ref):
            assert np.array_equal(g.ids, w.ids)
            np.testing.assert_allclose(g.dists, w.dists, rtol=1e-5)
            assert g.stats.D_calls == w.stats.D_calls
    else:
        q_D = eng._rows(engine_parts[1].embed(np.stack([r.tokens
                                                        for r in reqs])))
        for i, g in enumerate(got):
            assert 0 < g.stats.D_calls <= 12
            ids = torch.from_numpy(g.ids.astype(np.int32))[None]
            want = eng._wave_dists(q_D[i:i + 1], ids)[0].numpy()
            np.testing.assert_array_equal(g.dists, want.astype(np.float64))
    for f, want in zip([eng.submit(r) for r in reqs], got):
        _assert_same(f.result(timeout=WAIT), want)
    eng.close(timeout=WAIT)


# ------------------------------------------------------- beam-level primitives
def _toy_search_parts(n=64, dim=8, deg=6, b=4, seed=0):
    rng = np.random.default_rng(seed)
    corpus = torch.from_numpy(rng.normal(size=(n, dim)).astype(np.float32))
    adj = torch.from_numpy(rng.integers(0, n, (n, deg)).astype(np.int32))
    em = distances.EmbeddingMetric(corpus)
    q = torch.from_numpy(rng.normal(size=(b, dim)).astype(np.float32))
    return adj, em, q


def _host_drive(em, adj, q, state, safe, keep, quota, bw, ms, ew=1,
                cap=None):
    """The engine's stage-2 shape: host plan/score/commit loop."""
    while True:
        state = beam.commit_scores(state, safe, keep, em.dists_batch(q, safe))
        if not bool(beam.active_mask(state, beam_width=bw, quota=quota,
                                     max_steps=ms).any()):
            return state
        state, safe, keep, _ = beam.plan_step(
            state, adj, beam_width=bw, quota=quota, max_steps=ms,
            expand_width=ew, expand_cap=cap)


@pytest.mark.parametrize("dedup,cap", [("bitmap", None), ("sorted", 16)])
def test_reset_slots_matches_fresh_init(dedup, cap):
    """A recycled row equals a freshly initialized one; other rows pass
    through bit for bit."""
    adj, em, q = _toy_search_parts()
    b = q.shape[0]
    entries = torch.tensor([[1, 5, 9]] * b, dtype=torch.int32)
    quota = torch.tensor([10, 14, 0, 7], dtype=torch.int32)
    state, safe, keep = beam.init_state(
        entries, n_points=64, pool_size=8, quota=quota, dedup=dedup,
        set_capacity=cap)
    state = _host_drive(em, adj, q, state, safe, keep, quota, 8, 40)
    reset = torch.tensor([False, True, False, True])
    new_entries = torch.tensor([[2, 7]] * b, dtype=torch.int32)
    new_quota = torch.tensor([10, 9, 0, 12], dtype=torch.int32)
    st2, safe2, keep2 = beam.reset_slots(state, reset, new_entries, new_quota)
    for leaf, old in zip(st2[:3], state[:3]):
        assert torch.equal(leaf[[0, 2]], old[[0, 2]])
    assert not keep2[[0, 2]].any()
    st2 = _host_drive(em, adj, q, st2, safe2, keep2, new_quota, 8, 40)
    ref, rsafe, rkeep = beam.init_state(
        new_entries, n_points=64, pool_size=8, quota=new_quota, dedup=dedup,
        set_capacity=cap)
    ref = _host_drive(em, adj, q, ref, rsafe, rkeep, new_quota, 8, 40)
    for name in ("pool_ids", "pool_dists", "n_calls", "n_steps"):
        assert torch.equal(getattr(st2, name)[[1, 3]],
                           getattr(ref, name)[[1, 3]]), name


def test_grow_state_is_a_no_op():
    """Growing pool_size / set_capacity mid-search leaves the surviving
    prefix, call counts and steps unchanged."""
    adj, em, q = _toy_search_parts(seed=1)
    entries = torch.tensor([[1, 5, 9]] * q.shape[0], dtype=torch.int32)
    quota = torch.tensor([12, 9, 15, 6], dtype=torch.int32)

    def start():
        state, safe, keep = beam.init_state(
            entries, n_points=64, pool_size=8, quota=quota, dedup="sorted",
            set_capacity=16)
        state = beam.commit_scores(state, safe, keep,
                                   em.dists_batch(q, safe))
        return beam.plan_step(state, adj, beam_width=8, quota=quota,
                              max_steps=40)[:3]

    small = _host_drive(em, adj, q, *start(), quota, 8, 40)
    state, safe, keep = start()
    grown = beam.grow_state(state, pool_size=16, set_capacity=32)
    assert grown.pool_ids.shape[1] == 16 and grown.scored.capacity == 32
    big = _host_drive(em, adj, q, grown, safe, keep, quota, 8, 40)
    assert torch.equal(big.pool_ids[:, :8], small.pool_ids)
    assert torch.equal(big.pool_dists[:, :8], small.pool_dists)
    assert torch.equal(big.n_calls, small.n_calls)
    assert torch.equal(big.n_steps, small.n_steps)


def test_per_row_expand_width_vector():
    """A (B,) expand_width: each row matches the scalar run at its width."""
    adj, em, q = _toy_search_parts(seed=2)
    b = q.shape[0]
    entries = torch.tensor([[1, 5, 9]] * b, dtype=torch.int32)
    quota = torch.tensor([14] * 4, dtype=torch.int32)
    ew = torch.tensor([1, 2, 3, 1], dtype=torch.int32)

    def run(expand, cap=None):
        state, safe, keep = beam.init_state(
            entries, n_points=64, pool_size=8, quota=quota, dedup="bitmap")
        return _host_drive(em, adj, q, state, safe, keep, quota, 8, 40,
                           ew=expand, cap=cap)

    mixed = run(ew, cap=3)
    for row, e in enumerate(ew.tolist()):
        solo = run(int(e))
        assert torch.equal(mixed.pool_ids[row], solo.pool_ids[row])
        assert torch.equal(mixed.n_calls[row], solo.n_calls[row])


# ---------------------------------------------------------- device rule
def test_engine_device_rule(engine_parts):
    """No card and no device="cpu": raise. A tower on the other kind of
    device: ValueError. shards > 1: NotImplementedError naming
    ShardedStepper."""
    cheap, expensive, corpus = engine_parts
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            BiMetricEngine(cheap, expensive, corpus)

    class OnCard:
        device = torch.device("cuda")

        def embed(self, tokens, batch=64):
            raise AssertionError("never called")

    with pytest.raises(ValueError, match="tower"):
        BiMetricEngine(cheap, OnCard(), corpus, device=CPU)
    with pytest.raises(NotImplementedError, match="ShardedStepper"):
        BiMetricEngine(cheap, expensive, corpus, shards=2, device=CPU)


# ------------------------------------------------------------------ launcher
def test_launcher_serves_within_quota(capsys):
    """``python -m repro_torch.launch.serve --device cpu`` at its smallest
    sizes: every query spends at most its quota of D calls."""
    quota = 8
    launch_serve.main(["--device", "cpu", "--corpus", "48", "--queries",
                       "2", "--quota", str(quota), "--seq", "8"])
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("q")]
    assert len(lines) == 2, out
    for ln in lines:
        calls = [int(p.split("D calls ")[1].split(")")[0])
                 for p in ln.split("|")]
        assert len(calls) == 2 and all(0 < c <= quota for c in calls), ln
