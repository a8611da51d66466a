"""The port's serving engine against ``repro.serve.engine`` on the CPU.

Both engines take one shared NumPy stub tower pair (a seeded token table,
averaged over a row's tokens and normalised), so their embeddings are the
same bits, and the port's engine searches the JAX engine's Vamana graph
(its ``vamana.build`` is patched to return ``convert.index_from_numpy`` of
it: the two packages draw different initial graphs). The cover tree is
built by each engine: the port's build gives the JAX tree exactly. ids,
``D_calls``, ``d_calls`` and ``tower_batches`` must match exactly, dists
to rtol 1e-5.

Then the JAX tests' smoke towers through ``convert.transformer_from_numpy``
(embeddings within 2e-5, ids equal but at a near-tie of relative gap
1e-5), the slot primitives of ``core/beam.py`` on one NumPy state, and
``FaultPlan``'s decisions.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import qwen3_0_6b
from repro.core import beam as jbeam
from repro.models import transformer as JT
from repro.serve import engine as JE
from repro.serve import faults as JF
from repro_torch import convert
from repro_torch.core import beam as tbeam
from repro_torch.core import vamana as tvamana
from repro_torch.models import transformer as TT
from repro_torch.serve import engine as TE
from repro_torch.serve import faults as TF

CPU = "cpu"
VOCAB = 512
ROWS = (3, 40, 77, 12)
TIE_GAP = 1e-5  # chip_smoke phase 3's near-tie rule


class StubTower:
    """A NumPy tower: a seeded (vocab, dim) table averaged over a row's
    tokens and normalised to unit length; a row never sees its batch."""

    def __init__(self, dim, seed):
        self.table = np.random.default_rng(seed).normal(
            size=(VOCAB, dim)).astype(np.float32)

    def embed(self, tokens, batch=64):
        e = self.table[np.asarray(tokens)].mean(1)
        return (e / np.linalg.norm(e, axis=1, keepdims=True)).astype(
            np.float32)


@pytest.fixture(scope="module")
def parts():
    corpus = np.random.default_rng(0).integers(0, VOCAB, (96, 10),
                                               dtype=np.int32)
    return StubTower(16, 1), StubTower(32, 2), corpus


def _port_engine(je, cheap, expensive, corpus, **kw):
    """The port's engine on the CPU, searching ``je``'s graph."""
    with pytest.MonkeyPatch.context() as mp:
        if je.index is not None:
            mp.setattr(tvamana, "build", lambda *a, **k: (
                convert.index_from_numpy(np.asarray(je.index.adjacency),
                                         int(je.index.medoid),
                                         je.index.config, device=CPU)))
        return TE.BiMetricEngine(cheap, expensive, corpus, device=CPU, **kw)


@pytest.fixture(scope="module")
def engines(parts):
    """(index, dedup) -> (JAX engine, port engine), built once each."""
    cheap, expensive, corpus = parts

    @functools.cache
    def make(index="vamana", dedup="auto"):
        je = JE.BiMetricEngine(cheap, expensive, corpus, index=index,
                               dedup=dedup)
        return je, _port_engine(je, cheap, expensive, corpus, index=index,
                                dedup=dedup)

    return make


def _requests(corpus, quotas, **per_req):
    """Parallel JAX and port SearchRequests, ``per_req`` values per row."""
    out = []
    for mod in (JE, TE):
        out.append([mod.SearchRequest(
            tokens=corpus[r], quota=q, k=5,
            **{key: v[i] for key, v in per_req.items()})
            for i, (r, q) in enumerate(zip(ROWS, quotas))])
    return out


def _assert_same(jres, tres):
    assert len(jres) == len(tres)
    for i, (a, b) in enumerate(zip(jres, tres)):
        assert np.array_equal(a.ids, b.ids), (i, a.ids, b.ids)
        np.testing.assert_allclose(b.dists, a.dists, rtol=1e-5)
        for f in ("D_calls", "d_calls", "tower_batches"):
            assert getattr(a.stats, f) == getattr(b.stats, f), (i, f)


SYNC_CASES = {
    "quota0": dict(quotas=[0, 0, 0, 0]),
    "quota12": dict(quotas=[12] * 4),
    "quota15": dict(quotas=[15] * 4),
    "mixed_quota": dict(quotas=[4, 15, 9, 0]),
    "n_seeds": dict(quotas=[15] * 4, n_seeds=[3, 7, 1, None]),
    "expand_width3": dict(quotas=[15] * 4, expand_width=[3] * 4),
    "expand_width_mixed": dict(quotas=[15, 12, 15, 9],
                               expand_width=[1, 3, 3, 1]),
}


@pytest.mark.parametrize("case", list(SYNC_CASES))
def test_query_batch_matches_jax(parts, engines, case):
    """Vamana: the port engine answers JAX's, row for row, stats included."""
    spec = dict(SYNC_CASES[case])
    jreq, treq = _requests(parts[2], spec.pop("quotas"), **spec)
    je, te = engines()
    _assert_same(je.query_batch(jreq), te.query_batch(treq))


@pytest.mark.parametrize("case", ["quota0", "quota12", "quota15",
                                  "mixed_quota"])
def test_covertree_query_batch_matches_jax(parts, engines, case):
    """Cover tree: the port builds the JAX tree and descends it alike."""
    jreq, treq = _requests(parts[2], SYNC_CASES[case]["quotas"])
    je, te = engines("covertree")
    assert te._flat.depth == len(je._flat.radii) + 1
    np.testing.assert_array_equal(te._flat.root_ids, je._flat.root_ids)
    _assert_same(je.query_batch(jreq), te.query_batch(treq))


@pytest.mark.parametrize("dedup", ["sorted", "bitmap", "auto"])
def test_dedup_backends_match_jax(parts, engines, dedup):
    jreq, treq = _requests(parts[2], [4, 15, 9, 0])
    je, te = engines(dedup=dedup)
    jr, tr = je.query_batch(jreq), te.query_batch(treq)
    _assert_same(jr, tr)
    assert [r.stats.D_calls for r in tr] == [4, 15, 9, 0]


def test_rerank_matches_jax(parts, engines):
    je, te = engines()
    toks = parts[2][list(ROWS)]
    ij, dj, sj = je.rerank_query_batch(toks, quota=16, k=5)
    it, dt, st = te.rerank_query_batch(toks, quota=16, k=5)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_allclose(dt, dj, rtol=1e-5)
    for a, b in zip(sj, st):
        assert (a.D_calls, a.d_calls, a.tower_batches) == (
            b.D_calls, b.d_calls, b.tower_batches)
    assert all(s.D_calls <= 16 for s in st)


def test_legacy_query_batch_matches_jax(parts, engines):
    """The legacy (tokens, quota=...) form: padded (B, k) arrays."""
    je, te = engines()
    toks = parts[2][list(ROWS)]
    quotas = np.array([4, 15, 9, 0], np.int32)
    form = ("query_batch", "query_batch(tokens, quota=...)")
    JE._warned.discard(form)  # each warns once a process
    TE._warned.discard(form)
    with pytest.warns(DeprecationWarning):
        jids, jdd, jst = je.query_batch(toks, quota=quotas, k=5)
    with pytest.warns(DeprecationWarning):
        tids, tdd, tst = te.query_batch(toks, quota=quotas, k=5)
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_allclose(tdd, jdd, rtol=1e-5)
    assert [s.D_calls for s in tst] == [s.D_calls for s in jst]


# --------------------------------------------------------------- smoke towers
def _exp_smoke():
    return JT.TransformerConfig(
        name="exp-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=128, vocab=qwen3_0_6b.smoke().vocab, embed_dim=32)


@pytest.fixture(scope="module")
def smoke_towers():
    """The JAX tests' smoke towers and the port's copies of them."""
    key = jax.random.PRNGKey(0)
    out = {}
    for name, cfg, k in (("cheap", qwen3_0_6b.smoke(), key),
                         ("expensive", _exp_smoke(),
                          jax.random.fold_in(key, 1))):
        params = JT.init_params(k, cfg)
        pcfg = TT.TransformerConfig(**{**dataclasses.asdict(cfg),
                                       "dtype": torch.float32})
        model = convert.transformer_from_numpy(
            jax.tree.map(np.asarray, params), pcfg, device=CPU)
        out[name] = (JE.EmbedTower(params, cfg),
                     TE.EmbedTower(model, device=CPU))
    return out


@pytest.mark.parametrize("tower", ["cheap", "expensive"])
def test_smoke_tower_embeds_match_jax(parts, smoke_towers, tower):
    jt, tt = smoke_towers[tower]
    corpus = parts[2]
    np.testing.assert_allclose(tt.embed(corpus), jt.embed(corpus), atol=2e-5,
                               rtol=0)


def test_smoke_tower_engines_agree(parts, smoke_towers):
    """The engines on the real towers: ids equal, but where the first
    difference of a row is a near-tie under D (relative gap <= 1e-5)."""
    corpus = parts[2]
    (jc, tc), (jx, tx) = smoke_towers["cheap"], smoke_towers["expensive"]
    je = JE.BiMetricEngine(jc, jx, corpus)
    te = _port_engine(je, tc, tx, corpus)
    jreq, treq = _requests(corpus, [4, 15, 9, 12])
    jr, tr = je.query_batch(jreq), te.query_batch(treq)
    docs = tx.embed(corpus).astype(np.float64)
    for r, a, b in zip(ROWS, jr, tr):
        assert b.stats.D_calls <= int(treq[ROWS.index(r)].quota)
        if np.array_equal(a.ids, b.ids):
            np.testing.assert_allclose(b.dists, a.dists, rtol=1e-4)
            continue
        q = tx.embed(corpus[r][None])[0].astype(np.float64)
        i = int(np.nonzero(a.ids != b.ids)[0][0])
        da, db = (np.linalg.norm(docs[int(v)] - q)
                  for v in (a.ids[i], b.ids[i]))
        assert abs(da - db) / max(da, db, 1e-30) <= TIE_GAP, (r, i, da, db)


# ------------------------------------------------------- slot primitives
def _jax_state(dedup, seed):
    """A JAX search state a few waves in, on a toy graph."""
    rng = np.random.default_rng(seed)
    corpus = rng.normal(size=(64, 8)).astype(np.float32)
    adj = jnp.asarray(rng.integers(0, 64, (64, 6)), jnp.int32)
    q = jnp.asarray(rng.normal(size=(4, 8)).astype(np.float32))
    emb = jnp.asarray(corpus)

    def dists(ids):
        d = jnp.sqrt(((emb[jnp.maximum(ids, 0)] - q[:, None]) ** 2).sum(-1))
        return jnp.where(ids >= 0, d, jnp.inf)

    quota = jnp.asarray([10, 14, 0, 7], jnp.int32)
    state, safe, keep = jbeam.init_state(
        jnp.asarray([[1, 5, 9]] * 4, jnp.int32), n_points=64, pool_size=8,
        quota=quota, dedup=dedup, set_capacity=16 if dedup == "sorted"
        else None)
    for _ in range(3):
        state = jbeam.commit_scores(state, safe, keep, dists(safe))
        state, safe, keep, _ = jbeam.plan_step(
            state, adj, beam_width=8, quota=quota, max_steps=40)
    return jbeam.commit_scores(state, safe, keep, dists(safe))


def _to_port(js):
    """The port's state holding a JAX state's values."""
    t = lambda a: torch.from_numpy(np.array(a))
    sc = js.scored
    scored = (tbeam.ScoredSet(t(sc.ids), t(sc.count))
              if isinstance(sc, jbeam.ScoredSet) else t(sc))
    return tbeam.BatchedSearchState(t(js.pool_ids), t(js.pool_dists),
                                    t(js.expanded), scored, t(js.n_calls),
                                    t(js.n_steps))


def _assert_state_equal(js, ts):
    for name in ("pool_ids", "pool_dists", "expanded", "n_calls", "n_steps"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)),
                                      err_msg=name)
    if isinstance(js.scored, jbeam.ScoredSet):
        np.testing.assert_array_equal(ts.scored.ids.numpy(),
                                      np.asarray(js.scored.ids))
        np.testing.assert_array_equal(ts.scored.count.numpy(),
                                      np.asarray(js.scored.count))
    else:
        np.testing.assert_array_equal(ts.scored.numpy(),
                                      np.asarray(js.scored))


@pytest.mark.parametrize("dedup", ["bitmap", "sorted"])
def test_reset_slots_matches_jax(dedup):
    js = _jax_state(dedup, seed=0)
    ts = _to_port(js)
    reset = np.array([False, True, False, True])
    entries = np.array([[2, 7, 2, -1]] * 4, np.int32)  # a repeat and a pad
    quota = np.array([10, 1, 0, 12], np.int32)
    js2, jsafe, jkeep = jbeam.reset_slots(
        js, jnp.asarray(reset), jnp.asarray(entries), jnp.asarray(quota))
    ts2, tsafe, tkeep = tbeam.reset_slots(
        ts, torch.from_numpy(reset), torch.from_numpy(entries),
        torch.from_numpy(quota))
    _assert_state_equal(js2, ts2)
    np.testing.assert_array_equal(tsafe.numpy(), np.asarray(jsafe))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    _assert_state_equal(js, ts)  # the input state is not modified


@pytest.mark.parametrize("dedup", ["bitmap", "sorted"])
def test_grow_state_matches_jax(dedup):
    js = _jax_state(dedup, seed=1)
    ts = _to_port(js)
    for kw in (dict(pool_size=16, set_capacity=32), dict(pool_size=4),
               dict(set_capacity=8)):
        _assert_state_equal(jbeam.grow_state(js, **kw),
                            tbeam.grow_state(ts, **kw))


def test_early_resolve_matches_jax():
    js = _jax_state("bitmap", seed=2)
    ts = _to_port(js)
    for rows in ([False, True, False, True], True, False):
        _assert_state_equal(
            jbeam.early_resolve(js, jnp.asarray(rows)),
            tbeam.early_resolve(ts, torch.as_tensor(rows)))


# ------------------------------------------------------------ fault plans
def _decisions(plan, fault_cls, sites, n=60):
    out = []
    for i in range(n):
        site = sites[i % len(sites)]
        try:
            plan.fire(site)
            out.append((site, 0))
        except fault_cls as exc:
            out.append((site, 1, exc.call_index, exc.transient))
    return out, [(plan.fired(s), plan.calls(s)) for s in sites]


@pytest.mark.parametrize("seed", [0, 7, 11])
def test_fault_plan_matches_jax(seed):
    """The port's copy of FaultPlan makes JAX's decisions, call for call."""
    specs = lambda m: dict(
        drain=m.FaultSpec(rate=0.3, burst=2),
        embed_queries=m.FaultSpec(rate=0.2, mode="persistent", after=5),
        cheap_embed=m.FaultSpec(rate=0.5, mode="hang"))
    sites = ("drain", "embed_queries", "cheap_embed")
    want = _decisions(JF.FaultPlan(seed, **specs(JF)), JF.InjectedFault,
                      sites)
    got = _decisions(TF.FaultPlan(seed, **specs(TF)), TF.InjectedFault,
                     sites)
    assert got == want
    assert sum(d[1] for d in got[0]) > 0
