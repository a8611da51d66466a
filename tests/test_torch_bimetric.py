"""The port's slice as a whole vs the JAX reference, at small size.

One synthetic bi-metric dataset (drawn with numpy) and one Vamana graph
(built by the port, handed to the JAX package). Then ``bimetric_search``
(scalar and (B,) quota, no stage 1, int8 proxy residency on stage 1) and
``rerank_search`` run in both packages: ids, ``d_calls`` and ``D_calls``
exact, distances within 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bimetric as jbm
from repro.core import distances as jdist
from repro.core import vamana as jv
from repro_torch.configs.bimetric_paper import (CHEAP_EMBED_DIM,
                                                EXPENSIVE_EMBED_DIM,
                                                PAPER_DISKANN,
                                                BiMetricSystemConfig)
from repro_torch.core import bimetric as tbm
from repro_torch.core import distances as tdist
from repro_torch.core import metrics as tmetrics
from repro_torch.core import vamana as tv
from repro_torch.data import synthetic as tsyn

N = 1024
CFG = dict(max_degree=16, l_build=24, alpha=1.2, pool_size=48,
           rev_candidates=16, build_batch=512, n_rounds=2)


def _numpy_dataset(seed, n_queries=12, dim_D=48, dim_d=8):
    """The synthetic generator's construction, drawn with numpy: clustered
    D embeddings, a noisy JL-projected proxy with half-visible local
    detail, and extra noise on the proxy queries."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(32, dim_D)) * 4.0
    assign = rng.integers(0, 32, N)
    local = rng.normal(size=(N, dim_D))
    cD = centers[assign] + local
    qidx = rng.integers(0, N, n_queries)
    qn = 0.5 * rng.normal(size=(n_queries, dim_D))
    qD = cD[qidx] + qn
    proj = rng.normal(size=(dim_D, dim_d)) / np.sqrt(dim_d)
    cd = (centers[assign] + 0.5 * local) @ proj
    qd = (centers[assign[qidx]] + 0.5 * (local[qidx] + qn)) @ proj
    cd *= 1.0 + 0.1 * rng.normal(size=cd.shape)
    qd = qd * (1.0 + 0.1 * rng.normal(size=qd.shape)) + rng.normal(
        size=qd.shape)
    return [a.astype(np.float32) for a in (cD, cd, qD, qd)]


@pytest.fixture(scope="module")
def setup():
    np_data = _numpy_dataset(seed=1)
    cD, cd, qD, qd = (torch.from_numpy(np.array(a)) for a in np_data)
    tidx = tv.build(cd, tv.VamanaConfig(**CFG), device="cpu")
    jidx = jv.VamanaIndex(adjacency=jnp.asarray(tidx.adjacency.numpy()),
                          medoid=jnp.int32(tidx.medoid),
                          config=jv.VamanaConfig(**CFG))
    return np_data, (cD, cd, qD, qd), jidx, tidx


def _jax_fns(np_data):
    cD, cd = np_data[0], np_data[1]
    em_d = jdist.EmbeddingMetric(jnp.asarray(cd))
    em_D = jdist.EmbeddingMetric(jnp.asarray(cD))
    return em_d.dists, em_D.dists


def _torch_fns(t):
    cD, cd = t[0], t[1]
    return (tdist.EmbeddingMetric(cd).dists_batch,
            tdist.EmbeddingMetric(cD).dists_batch)


def _assert_same(j, t, ctx):
    np.testing.assert_array_equal(t.ids.numpy(), np.asarray(j.ids),
                                  err_msg=f"ids {ctx}")
    np.testing.assert_array_equal(t.d_calls.numpy(), np.asarray(j.d_calls),
                                  err_msg=f"d_calls {ctx}")
    np.testing.assert_array_equal(t.D_calls.numpy(), np.asarray(j.D_calls),
                                  err_msg=f"D_calls {ctx}")
    np.testing.assert_allclose(t.dists.numpy(), np.asarray(j.dists),
                               rtol=1e-5, atol=1e-5, err_msg=f"dists {ctx}")


@pytest.mark.parametrize("case", ["q80", "vector", "no_stage1",
                                  "int8_stage1"])
def test_bimetric_matches_jax(setup, case):
    np_data, t, jidx, tidx = setup
    jfd, jfD = _jax_fns(np_data)
    tfd, tfD = _torch_fns(t)
    kw = dict(n_points=N, k=10)
    jkw, tkw = {}, {}
    if case == "q80":
        kw["quota"] = 80
    elif case == "vector":
        qv = np.array([5, 20, 60, 90] * 3, np.int32)
        jkw["quota"], tkw["quota"] = jnp.asarray(qv), torch.from_numpy(qv)
        kw.update(n_seeds=20, beam_width_D=48)
    elif case == "no_stage1":
        kw.update(quota=40, use_stage1=False)
    else:
        kw.update(quota=60, quantize="int8")
        jkw["corpora"] = (jnp.asarray(np_data[1]), jnp.asarray(np_data[0]))
        tkw["corpora"] = (t[1], t[0])
    want = jbm.bimetric_search(
        lambda q, i: jfd(q, i), lambda q, i: jfD(q, i), jidx,
        jnp.asarray(np_data[3]), jnp.asarray(np_data[2]), **kw, **jkw)
    got = tbm.bimetric_search(tfd, tfD, tidx, t[3], t[2], device="cpu",
                              **kw, **tkw)
    _assert_same(want, got, case)
    quota = kw.get("quota", tkw.get("quota"))
    assert (got.D_calls.numpy() <= np.asarray(quota)).all()


@pytest.mark.parametrize("quota", [20, 80])
def test_rerank_matches_jax(setup, quota):
    np_data, t, jidx, tidx = setup
    jfd, jfD = _jax_fns(np_data)
    tfd, tfD = _torch_fns(t)
    want = jbm.rerank_search(jfd, jfD, jidx, jnp.asarray(np_data[3]),
                             jnp.asarray(np_data[2]), n_points=N,
                             quota=quota, k=10)
    got = tbm.rerank_search(tfd, tfD, tidx, t[3], t[2], n_points=N,
                            quota=quota, k=10, device="cpu")
    _assert_same(want, got, quota)
    assert (got.D_calls.numpy() == quota).all()


def test_single_matches_batch_and_quality(setup):
    np_data, t, jidx, tidx = setup
    tfd, tfD = _torch_fns(t)
    em_d, em_D = tdist.EmbeddingMetric(t[1]), tdist.EmbeddingMetric(t[0])
    batch = tbm.bimetric_search(tfd, tfD, tidx, t[3], t[2], n_points=N,
                                quota=80, device="cpu")
    for b in (0, 5):
        ids, dists, dc, Dc = tbm.bimetric_search_single(
            lambda i, b=b: em_d.dists(t[3][b], i),
            lambda i, b=b: em_D.dists(t[2][b], i), tidx, n_points=N,
            quota=80, device="cpu")
        assert torch.equal(ids, batch.ids[b])
        assert torch.equal(dists, batch.dists[b])
        assert int(dc) == int(batch.d_calls[b])
        assert int(Dc) == int(batch.D_calls[b])
    true_ids, _ = em_D.brute_force(t[2], 10)
    big = tbm.bimetric_search(tfd, tfD, tidx, t[3], t[2], n_points=N,
                              quota=700, device="cpu")
    assert float(tmetrics.recall_at_k(big.ids, true_ids).mean()) >= 0.95
    nd = tmetrics.ndcg_at_k(big.ids, true_ids)
    assert nd.shape == (12,) and float(nd.min()) > 0.5


def test_unported_index_kinds_raise(setup):
    np_data, t, jidx, tidx = setup
    tfd, tfD = _torch_fns(t)
    with pytest.raises(TypeError, match="FlatCoverTree"):
        tbm.bimetric_search(tfd, tfD, object(), t[3], t[2], n_points=N,
                            quota=10, device="cpu")
    with pytest.raises(ValueError, match="corpora"):
        tbm.bimetric_search(tfd, tfD, tidx, t[3], t[2], n_points=N,
                            quota=10, shards=2, device="cpu")
    with pytest.raises(ValueError, match="search_mesh"):
        tbm.bimetric_search(tfd, tfD, tidx, t[3], t[2], n_points=N,
                            quota=10, shards=2, corpora=(t[1], t[0]),
                            device="cpu")


def test_make_dataset_and_paper_config():
    data = tsyn.make_dataset(n=600, n_queries=5, dim_D=32, dim_d=8,
                             **{k: v for k, v in
                                tsyn.proxy_quality_sweep("bge-micro-like")
                                .items() if k != "dim_d"}, device="cpu")
    assert data.corpus_D.shape == (600, 32) and data.corpus_d.shape == (600, 8)
    assert data.queries_D.shape == (5, 32) and data.queries_d.shape == (5, 8)
    assert torch.isfinite(data.corpus_d).all() and data.c_estimate > 1.0
    again = tsyn.make_dataset(n=600, n_queries=5, dim_D=32, dim_d=8,
                              device="cpu")
    same = tsyn.make_dataset(n=600, n_queries=5, dim_D=32, dim_d=8,
                             device="cpu")
    assert torch.equal(again.corpus_d, same.corpus_d)
    assert (CHEAP_EMBED_DIM, EXPENSIVE_EMBED_DIM) == (384, 4096)
    assert PAPER_DISKANN._asdict() == {**jv.VamanaConfig(
        max_degree=64, l_build=125, alpha=1.2, pool_size=256,
        rev_candidates=64, metric="l2")._asdict()}
    sc = BiMetricSystemConfig()
    assert (sc.k, sc.quota, sc.seed_frac) == (10, 1000, 0.5)
