"""The port's corpus-sharded search vs the JAX reference, on the CPU.

The same numpy inputs go through both packages:

* the shard-local gather→score (``ops.gather_score_local``) against JAX's
  ``ref.gather_score_local_ref`` / ``gather_score_local_quant_ref`` and its
  Pallas kernel under ``pallas-interpret``, at the offset of every shard;
* the corpus placement (``shard_corpus`` / ``shard_corpus_view``);
* the sharded engine against the port's unsharded engine (bit-exact) and
  JAX's unsharded engine (ids, counts and scored sets exact);
* the entry points ``vamana.search`` and ``bimetric_search`` at shards=4.

In-process, JAX sees one CPU device, so the shards of the port run on a
mesh of ``["cpu"] * S``; the subprocess test at the end forces four host
devices and holds the port against JAX's own ``shard_map`` engine.
"""
import functools
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import beam as jbeam
from repro.core import bimetric as jbm
from repro.core import distances as jdist
from repro.core import vamana as jv
from repro.distributed import sharding as jsharding
from repro.kernels import backend as jbackend
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.convert import corpus_view_from_numpy, tensor_from_numpy
from repro_torch.core import beam as tbeam
from repro_torch.core import bimetric as tbm
from repro_torch.core import distances as tdist
from repro_torch.core import vamana as tv
from repro_torch.distributed import collectives, sharding
from repro_torch.kernels import backend as tbackend
from repro_torch.kernels import ops as tops

ROOT = Path(__file__).resolve().parents[1]
METRICS = ["l2", "sqeuclidean", "ip", "cosine"]
CPU = "cpu"


def _t(a):
    return tensor_from_numpy(a, CPU)


def _mesh(s):
    return sharding.search_mesh(s, devices=[CPU] * s)


def _jview_np(view):
    return [None if f is None else np.asarray(f) for f in view]


# --------------------------------------------------------------------------
# the shard-local kernel
# --------------------------------------------------------------------------
def _local_inputs(seed, n=97, dim=16, b=3, k=24):
    rng = np.random.default_rng(seed)
    corpus = rng.normal(size=(n, dim)).astype(np.float32)
    corpus[5] = 0.0  # a zero row: cosine must be exactly 1.0
    qs = rng.normal(size=(b, dim)).astype(np.float32)
    ids = rng.integers(-1, n, size=(b, k)).astype(np.int32)
    ids[:, 0] = 5
    ids[:, 1] = -1
    ids[:, 2] = n - 1  # the last real row, next to the padding
    return corpus, qs, ids


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("form", ["reduce", "matmul", "int8"])
@pytest.mark.parametrize("metric", METRICS)
def test_gather_score_local_matches_jax(metric, form, shards):
    """Owned lanes equal JAX's oracle (1e-5; 1e-4 in matmul form) and its
    Pallas kernel (1e-4); foreign and padding lanes are exactly 0.0; the sum
    over the shards is the port's unsharded gather bit for bit."""
    corpus, qs, ids = _local_inputs(seed=len(metric) * 7 + len(form) + shards)
    n = corpus.shape[0]
    jq, jids = jnp.asarray(qs), jnp.asarray(ids)
    if form == "int8":
        jfull = jbackend.as_corpus_view(jnp.asarray(corpus), quantize="int8")
        tfull = corpus_view_from_numpy(*_jview_np(jfull), device=CPU)
        jst = jsharding.shard_corpus_view(jfull, shards)
        tst = sharding.shard_corpus_view(tfull, shards)
        n_local = tst[-1]
        jblock = lambda s: jbackend.CorpusView(*(a[s] for a in jst[:5]))
        tblock = lambda s: tbackend.CorpusView(*(a[s] for a in tst[:5]))
        backends = ("ref", "matmul")
    else:
        tfull = _t(corpus)
        jst, n_local = jsharding.shard_corpus(jnp.asarray(corpus), shards)
        tst, _ = sharding.shard_corpus(tfull, shards)
        jblock = lambda s: jst[s]
        tblock = lambda s: tst[s]
        backends = (form if form == "matmul" else "ref",)
    tol = 1e-4 if form == "matmul" else 1e-5
    parts = {be: [] for be in backends}
    for s in range(shards):
        off = s * n_local
        assert collectives.shard_offset(s, n_local) == off
        loc = ids - off
        owned = (ids >= 0) & (loc >= 0) & (loc < n_local)
        jb = jblock(s)
        if form == "int8":
            want = np.asarray(jref.gather_score_local_quant_ref(
                jb.rows, jb.scales, jb.zero_points, jq, jids, off, metric))
        else:
            want = np.asarray(jref.gather_score_local_ref(jb, jq, jids, off,
                                                          metric))
        pallas = np.asarray(jops.gather_score_local(
            jb, jq, jids, off, metric=metric, backend="pallas-interpret"))
        for be in backends:
            got = tops.gather_score_local(tblock(s), _t(qs), _t(ids), off,
                                          metric=metric, backend=be).numpy()
            parts[be].append(got)
            assert (got[~owned] == 0.0).all() and (want[~owned] == 0.0).all()
            btol = 1e-4 if be == "matmul" else tol
            np.testing.assert_allclose(got[owned], want[owned], rtol=btol,
                                       atol=btol)
            np.testing.assert_allclose(got[owned], pallas[owned], rtol=1e-4,
                                       atol=1e-4)
            if metric == "cosine" and 0 <= 5 - off < n_local:
                assert (got[:, 0] == 1.0).all()
    for be in backends:
        total = _t(parts[be][0])
        for p in parts[be][1:]:
            total = total + _t(p)
        total = torch.where(_t(ids) >= 0, total, torch.inf)
        full = tops.gather_score(tfull, _t(qs), _t(ids), metric=metric,
                                 backend=be)
        assert torch.equal(total, full), be
    assert n_local * shards >= n > n_local * (shards - 1)


# --------------------------------------------------------------------------
# placement
# --------------------------------------------------------------------------
@pytest.mark.parametrize("mode", [None, "int8", "fp8", "fp8_e5m2"])
@pytest.mark.parametrize("shards", [2, 4])
def test_placement_matches_jax(mode, shards):
    """Rows, codes, scales and zero points equal JAX's placement exactly at
    an uneven N (norms to f32 rounding, as for the views themselves); a
    prebuilt view is placed exactly as JAX places it; pad rows are inert."""
    rng = np.random.default_rng(shards)
    n, dim = 97, 12
    corpus = (rng.normal(size=(n, dim)) * 2.0).astype(np.float32)
    jrows, jn_local = jsharding.shard_corpus(jnp.asarray(corpus), shards)
    trows, n_local = sharding.shard_corpus(_t(corpus), shards)
    assert n_local == jn_local and n_local * shards > n
    np.testing.assert_array_equal(trows.numpy(), np.asarray(jrows))

    def same_bits(t, j):
        j = _t(np.asarray(j))
        assert t.dtype == j.dtype and t.shape == j.shape
        assert torch.equal(t.reshape(-1).view(torch.uint8),
                           j.reshape(-1).view(torch.uint8))

    jst = jsharding.shard_corpus_view(jnp.asarray(corpus), shards,
                                      quantize=mode)
    tst = sharding.shard_corpus_view(_t(corpus), shards, quantize=mode)
    assert tst[-1] == jst[-1] == n_local
    same_bits(tst[0], jst[0])
    for t, j in zip(tst[1:3], jst[1:3]):  # norms of the (dequantized) rows
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6)
    for t, j in zip(tst[3:5], jst[3:5]):  # scales, zero points
        same_bits(t, j)
    flat_sq = tst[1].reshape(-1)
    assert (flat_sq[n:] == 0.0).all()

    # a prebuilt view: pure data movement, equal to JAX's bit for bit
    jview = jbackend.as_corpus_view(jnp.asarray(corpus), quantize=mode)
    tview = corpus_view_from_numpy(*_jview_np(jview), device=CPU)
    jst = jsharding.shard_corpus_view(jview, shards)
    tst = sharding.shard_corpus_view(tview, shards)
    for t, j in zip(tst[:5], jst[:5]):
        same_bits(t, j)
    flat = tst[0].reshape(shards * n_local, dim)
    assert (flat[n:].float() == 0.0).all()
    with pytest.raises(ValueError):
        sharding.shard_corpus_view(tview, shards,
                                   quantize="int8" if mode != "int8"
                                   else "fp8")


def test_search_mesh():
    mesh = sharding.search_mesh(3, devices=["cpu"] * 3)
    assert mesh.size == 3 and mesh.devices == (torch.device("cpu"),) * 3
    assert sharding.SEARCH_AXIS == jsharding.SEARCH_AXIS
    assert sharding.search_mesh(1, device="cpu").devices == (
        torch.device("cpu"),)
    with pytest.raises(ValueError, match=r"search_mesh\(4, devices="):
        sharding.search_mesh(4, device="cpu")
    with pytest.raises(ValueError):
        sharding.search_mesh(2, devices=["cpu"])


def test_mixed_mesh_raises():
    """A mesh is of one device type, and the search runs on that type: no
    shard may fall back to the plain versions beside shards on another
    device."""
    with pytest.raises(ValueError, match="mix types"):
        sharding.search_mesh(2, devices=["cpu", "meta"])
    adj, emb, qs, entries = _random_graph(seed=3, n=97)
    args = (_t(emb), _t(adj), _t(qs), _t(entries))
    mixed = sharding.SearchMesh((torch.device("cpu"), torch.device("meta")))
    other = sharding.SearchMesh((torch.device("meta"),) * 2)
    for mesh in (mixed, other):
        with pytest.raises(ValueError, match="the search runs on cpu"):
            tbeam.sharded_greedy_search(*args, shards=2, mesh=mesh,
                                        device=CPU, **ENGINE_KW)


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------
def _random_graph(seed, n, r=6, dim=8, b=5):
    rng = np.random.default_rng(seed)
    adj = rng.integers(0, n, (n, r)).astype(np.int32)
    adj[rng.random((n, r)) < 0.2] = -1  # ragged out-degrees
    emb = rng.normal(size=(n, dim)).astype(np.float32)
    qs = rng.normal(size=(b, dim)).astype(np.float32)
    entries = np.broadcast_to(np.array([0, n // 2, n - 1], np.int32),
                              (b, 3)).copy()
    return adj, emb, qs, entries


ENGINE_KW = dict(beam_width=8, pool_size=16, max_steps=100)


def _bitmap_count(scored_locals):
    """(B,) popcount of the partitioned bitmap: the sum of its slices'."""
    return sum(sl.sum(dim=1, dtype=torch.int32) for sl in scored_locals)


@functools.lru_cache(maxsize=None)
def _jax_engine(n, quota):
    adj, emb, qs, entries = _random_graph(seed=n, n=n)
    em = jdist.EmbeddingMetric(jnp.asarray(emb))
    res = jbeam.batched_greedy_search(
        em.dists_batch, jnp.asarray(adj), jnp.asarray(qs),
        jnp.asarray(entries), n_points=n, quota=quota, dedup="bitmap",
        **ENGINE_KW)
    return [np.asarray(a) for a in res]


@pytest.mark.parametrize("quota", [19, "none"])
@pytest.mark.parametrize("n", [130, 97])
@pytest.mark.parametrize("shards", [1, 2, 4])
def test_sharded_engine_matches(shards, n, quota):
    """shards ∈ {1, 2, 4} on an uneven N, both dedup backends: every field
    bit-exact against the port's unsharded engine, and equal to JAX's
    unsharded engine (pool ids, n_calls, n_steps, scored exact; dists
    within 1e-5)."""
    q = tbeam.NO_QUOTA if quota == "none" else quota
    adj, emb, qs, entries = _random_graph(seed=n, n=n)
    want = _jax_engine(n, q)
    for dedup in ("bitmap", "sorted"):
        if dedup == "sorted" and q == tbeam.NO_QUOTA:
            continue  # an unbounded quota has no finite set capacity
        base = tbeam.batched_greedy_search(
            tbeam.fused_dist_fn(_t(emb), "l2"), _t(adj), _t(qs), _t(entries),
            n_points=n, quota=q, dedup=dedup, **ENGINE_KW)
        got = tbeam.sharded_greedy_search(
            _t(emb), _t(adj), _t(qs), _t(entries), shards=shards,
            metric="l2", mesh=_mesh(shards), quota=q, dedup=dedup,
            device=CPU, **ENGINE_KW)
        assert got.scored.shape == (5, n)
        for name, a, b in zip(got._fields, base, got):
            assert torch.equal(a, b), (dedup, name)
        for name, j, t in zip(got._fields, want, got):
            if name == "pool_dists":
                np.testing.assert_allclose(t.numpy(), j, rtol=1e-5,
                                           atol=1e-5)
            else:
                np.testing.assert_array_equal(t.numpy(), j,
                                              err_msg=f"{dedup} {name}")
    assert (want[3] <= q).all()


@pytest.mark.parametrize("n", [130, 97])
def test_partition_holds_at_every_step(n):
    """Driven step by step at S=4: the sharded bitmap's lookups equal the
    unsharded bitmap's, its slices partition it (their popcounts sum to the
    global popcount), and the replicated sorted set counts the same ids."""
    shards = 4
    adj, emb, qs, entries = _random_graph(seed=n + 1, n=n)
    stacked, n_local = sharding.shard_corpus(_t(emb), shards)
    blocks = [stacked[s] for s in range(shards)]
    ctx = tbeam.ShardCtx(_mesh(shards).devices, n_local)
    fn = tbeam.fused_dist_fn(_t(emb), "l2")

    def sharded_fn(q, ids):
        return collectives.wave_gather_score(blocks, q, ids, metric="l2")

    kw = dict(n_points=n, pool_size=16, quota=40)
    ent = _t(entries)
    plain, safe, keep = tbeam.init_state(ent, **kw)
    shb, _, _ = tbeam.init_state(ent, shard=ctx, **kw)
    srt, _, _ = tbeam.init_state(ent, shard=ctx, dedup="sorted",
                                 set_capacity=40, **kw)
    d = fn(_t(qs), safe)
    assert torch.equal(sharded_fn(_t(qs), safe), d)
    states = [tbeam.commit_scores(st, safe, keep, d)
              for st in (plain, shb, srt)]
    plan = dict(beam_width=8, quota=40, max_steps=100)
    for _ in range(12):
        plain, shb, srt = states
        probe = _t(adj)[plain.pool_ids.clamp(min=0).long()].reshape(5, -1)
        assert torch.equal(
            collectives.bitmap_lookup(shb.scored, probe),
            tbeam._scored_lookup(plain.scored, probe))
        assert torch.equal(
            tops.sorted_set_lookup(srt.scored.ids, probe),
            tbeam._scored_lookup(plain.scored, probe))
        count = plain.scored.sum(dim=1, dtype=torch.int32)
        assert torch.equal(_bitmap_count(shb.scored), count)
        assert torch.equal(tops.sorted_set_unique_count(srt.scored.ids),
                           count)
        for s, sl in enumerate(shb.scored):
            lo = s * n_local
            assert torch.equal(sl[:, :max(min(n - lo, n_local), 0)],
                               plain.scored[:, lo:lo + n_local])
        nxt = []
        for st, shard in ((plain, None), (shb, ctx), (srt, ctx)):
            st, safe, keep, _ = tbeam.plan_step(st, _t(adj), shard=shard,
                                                **plan)
            dd = (fn if shard is None else sharded_fn)(_t(qs), safe)
            nxt.append(tbeam.commit_scores(st, safe, keep, dd))
        for st in nxt[1:]:
            assert torch.equal(st.pool_ids, nxt[0].pool_ids)
            assert torch.equal(st.n_calls, nxt[0].n_calls)
        marked = torch.where(keep, safe, torch.full_like(safe, -1))
        pad = torch.full_like(safe, tops.SET_PAD)
        assert torch.equal(
            tops.sorted_set_merge(srt.scored.ids, torch.where(keep, safe, pad)),
            nxt[2].scored.ids)
        assert torch.equal(
            collectives.bitmap_lookup(nxt[1].scored, marked), keep)
        states = nxt


# --------------------------------------------------------------------------
# the entry points
# --------------------------------------------------------------------------
N_ENTRY = 160


@pytest.fixture(scope="module")
def dataset():
    rng = np.random.default_rng(5)
    centers = rng.normal(size=(8, 16)) * 3.0
    assign = rng.integers(0, 8, N_ENTRY)
    cD = (centers[assign] + rng.normal(size=(N_ENTRY, 16))).astype(np.float32)
    proj = rng.normal(size=(16, 8)) / np.sqrt(8)
    cd = (cD @ proj + 0.1 * rng.normal(size=(N_ENTRY, 8))).astype(np.float32)
    qidx = rng.integers(0, N_ENTRY, 6)
    qD = (cD[qidx] + 0.3 * rng.normal(size=(6, 16))).astype(np.float32)
    qd = (qD @ proj + 0.1 * rng.normal(size=(6, 8))).astype(np.float32)
    cfg = tv.VamanaConfig(max_degree=8, l_build=12, pool_size=24,
                          rev_candidates=8, build_batch=64)
    idx = tv.build(_t(cd), cfg, device=CPU)
    jidx = jv.VamanaIndex(adjacency=jnp.asarray(idx.adjacency.numpy()),
                          medoid=jnp.int32(idx.medoid),
                          config=jv.VamanaConfig(**cfg._asdict()))
    return dict(cD=cD, cd=cd, qD=qD, qd=qd, idx=idx, jidx=jidx)


@pytest.mark.parametrize("expand_width", [1, 2])
def test_vamana_search_sharded(dataset, expand_width):
    """shards=4 equals shards=1 bit for bit, and JAX's search on the same
    graph (ids and calls exact)."""
    x, q, idx = _t(dataset["cd"]), _t(dataset["qd"]), dataset["idx"]
    kw = dict(k=5, beam_width=12, expand_width=expand_width, device=CPU)
    base = tv.search(idx, x, q, **kw)
    got = tv.search(idx, x, q, shards=4, mesh=_mesh(4), **kw)
    for a, b in zip(base, got):
        assert torch.equal(a, b)
    ji, _, jc = jv.search(dataset["jidx"], jnp.asarray(dataset["cd"]),
                          jnp.asarray(dataset["qd"]), k=5, beam_width=12,
                          expand_width=expand_width)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ji))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(jc))


def _bimetric(dataset, **kw):
    t = {k: _t(dataset[k]) for k in ("cD", "cd", "qD", "qd")}
    fd = tdist.EmbeddingMetric(t["cd"]).dists_batch
    fD = tdist.EmbeddingMetric(t["cD"]).dists_batch
    return tbm.bimetric_search(fd, fD, dataset["idx"], t["qd"], t["qD"],
                               n_points=N_ENTRY, quota=48, k=5, device=CPU,
                               **kw)


def test_bimetric_search_sharded(dataset):
    """shards=4 over corpora equals the unsharded run on metric callables
    bit for bit, and JAX's unsharded run (ids and counts exact)."""
    corpora = (_t(dataset["cd"]), _t(dataset["cD"]))
    base = _bimetric(dataset)
    got = _bimetric(dataset, shards=4, corpora=corpora, mesh=_mesh(4))
    for a, b in zip(base, got):
        assert torch.equal(a, b)
    assert (got.D_calls <= 48).all()
    em_d = jdist.EmbeddingMetric(jnp.asarray(dataset["cd"]))
    em_D = jdist.EmbeddingMetric(jnp.asarray(dataset["cD"]))
    want = jbm.bimetric_search(
        lambda q, i: em_d.dists(q, i), lambda q, i: em_D.dists(q, i),
        dataset["jidx"], jnp.asarray(dataset["qd"]),
        jnp.asarray(dataset["qD"]), n_points=N_ENTRY, quota=48, k=5)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.d_calls.numpy(),
                                  np.asarray(want.d_calls))
    np.testing.assert_array_equal(got.D_calls.numpy(),
                                  np.asarray(want.D_calls))


def test_bimetric_matmul_int8_sharded(dataset):
    """The norm-cache form with int8 stage-1 residency: shards=4 equals the
    unsharded run under the same backend bit for bit."""
    corpora = (_t(dataset["cd"]), _t(dataset["cD"]))
    kw = dict(corpora=corpora, backend="matmul", quantize="int8")
    base = _bimetric(dataset, **kw)
    got = _bimetric(dataset, shards=4, mesh=_mesh(4), **kw)
    for a, b in zip(base, got):
        assert torch.equal(a, b)
    assert (got.D_calls <= 48).all()


# --------------------------------------------------------------------------
# against JAX's own sharded engine, on four forced host devices
# --------------------------------------------------------------------------
@pytest.mark.slow
def test_port_matches_jax_sharded_engine():
    """The port's sharded engine (N=130, S ∈ {2, 4}) and sharded
    ``bimetric_search`` (S=4) against JAX's ``shard_map`` programs on four
    host devices. The three JAX programs compile concurrently to keep the
    test short."""
    code = textwrap.dedent("""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        import sys; sys.path.insert(0, "src")
        from concurrent.futures import ThreadPoolExecutor
        import jax, jax.numpy as jnp
        import numpy as np
        import torch
        from repro.core import beam as jbeam, bimetric as jbm
        from repro.core import vamana as jv
        from repro_torch.core import beam as tbeam, bimetric as tbm
        from repro_torch.core import vamana as tv
        from repro_torch.distributed.sharding import search_mesh
        assert len(jax.devices()) == 4

        t = lambda a: torch.from_numpy(np.array(a))
        mesh = lambda s: search_mesh(s, devices=["cpu"] * s)
        n = 130
        rng = np.random.default_rng(n)
        adj = rng.integers(0, n, (n, 6)).astype(np.int32)
        adj[rng.random((n, 6)) < 0.2] = -1
        emb = rng.normal(size=(n, 8)).astype(np.float32)
        qs = rng.normal(size=(5, 8)).astype(np.float32)
        ent = np.broadcast_to(np.array([0, n // 2, n - 1], np.int32),
                              (5, 3)).copy()
        ekw = dict(metric="l2", beam_width=8, pool_size=16, quota=19,
                   max_steps=100)

        cD = rng.normal(size=(160, 16)).astype(np.float32)
        cd = (cD[:, :8] + 0.1 * rng.normal(size=(160, 8))).astype(np.float32)
        qD = (cD[:6] + 0.3 * rng.normal(size=(6, 16))).astype(np.float32)
        qd = qD[:, :8].copy()
        cfg = tv.VamanaConfig(max_degree=8, l_build=12, pool_size=24,
                              rev_candidates=8, build_batch=64)
        idx = tv.build(t(cd), cfg, device="cpu")
        jidx = jv.VamanaIndex(adjacency=jnp.asarray(idx.adjacency.numpy()),
                              medoid=jnp.int32(idx.medoid),
                              config=jv.VamanaConfig(**cfg._asdict()))
        bkw = dict(n_points=160, quota=48, k=5, shards=4)

        def jax_engine(shards):
            return jax.block_until_ready(jbeam.sharded_greedy_search(
                jnp.asarray(emb), jnp.asarray(adj), jnp.asarray(qs),
                jnp.asarray(ent), shards=shards, **ekw))

        def jax_bimetric():
            return jax.block_until_ready(jbm.bimetric_search(
                None, None, jidx, jnp.asarray(qd), jnp.asarray(qD),
                corpora=(jnp.asarray(cd), jnp.asarray(cD)), **bkw))

        with ThreadPoolExecutor(3) as ex:
            futs = {2: ex.submit(jax_engine, 2), 4: ex.submit(jax_engine, 4),
                    "bimetric": ex.submit(jax_bimetric)}
            want = {k: f.result() for k, f in futs.items()}

        for shards in (2, 4):
            got = tbeam.sharded_greedy_search(
                t(emb), t(adj), t(qs), t(ent), shards=shards,
                mesh=mesh(shards), device="cpu", **ekw)
            for name, a, b in zip(got._fields, want[shards], got):
                a, b = np.asarray(a), b.numpy()
                if name == "pool_dists":
                    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)
                else:
                    assert np.array_equal(a, b), (shards, name)

        j = want["bimetric"]
        p = tbm.bimetric_search(None, None, idx, t(qd), t(qD),
                                corpora=(t(cd), t(cD)), mesh=mesh(4),
                                device="cpu", **bkw)
        for name in ("ids", "d_calls", "D_calls"):
            assert np.array_equal(np.asarray(getattr(j, name)),
                                  getattr(p, name).numpy()), name
        np.testing.assert_allclose(p.dists.numpy(), np.asarray(j.dists),
                                   rtol=1e-5, atol=1e-5)
        print("PORT_SHARDED_OK")
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert res.returncode == 0, res.stderr[-3000:]
    assert "PORT_SHARDED_OK" in res.stdout
