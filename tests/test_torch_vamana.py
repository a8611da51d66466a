"""Port Vamana build and search vs the JAX reference.

The port's ``build`` is fed the JAX package's own initial random graph
(torch cannot reproduce ``jax.random`` bits); from there both packages run
the same rounds of batched search, robust prune and reverse-edge folding,
and must give the same adjacency and medoid. ``search`` over one graph must
give the same ids and call counts.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distances as jdist
from repro.core import vamana as jv
from repro_torch.convert import index_from_numpy
from repro_torch.core import distances as tdist
from repro_torch.core import metrics as tmetrics
from repro_torch.core import vamana as tv

CFG = dict(max_degree=16, l_build=24, alpha=1.2, pool_size=48,
           rev_candidates=16, build_batch=256, n_rounds=2)
N, DIM = 512, 16


def _jax_init(n, r, seed=0):
    """The JAX package's initial graph draw (``vamana.build``)."""
    init = jax.random.randint(jax.random.PRNGKey(seed), (n, r), 0, n,
                              dtype=jnp.int32)
    self_ = jnp.arange(n, dtype=jnp.int32)[:, None]
    return np.asarray(jnp.where(init == self_, -1, init))


@pytest.fixture(scope="module")
def built():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(N, DIM)).astype(np.float32)
    jidx = jv.build(jnp.asarray(x), jv.VamanaConfig(**CFG))
    tidx = tv.build(torch.from_numpy(x), tv.VamanaConfig(**CFG),
                    init_adjacency=_jax_init(N, CFG["max_degree"]),
                    device="cpu")
    return x, jidx, tidx


def test_build_matches_jax(built):
    _, jidx, tidx = built
    assert tidx.medoid == int(jidx.medoid)
    a, b = np.asarray(jidx.adjacency), tidx.adjacency.numpy()
    assert b.dtype == np.int32 and b.shape == a.shape
    same = (a == b).all(axis=1).mean()
    assert same == 1.0, f"{same:.4f} of adjacency rows identical"


def test_build_invariants(built):
    _, _, tidx = built
    adj = tidx.adjacency.numpy()
    assert adj.shape[1] == CFG["max_degree"]
    assert (adj < N).all()
    assert not (adj == np.arange(N)[:, None]).any()


@pytest.mark.parametrize("quota", [None, 60, "mixed"])
def test_search_matches_jax(built, quota):
    x, jidx, tidx = built
    rng = np.random.default_rng(7)
    q = (x[:16] + 0.05 * rng.normal(size=(16, DIM))).astype(np.float32)
    if quota == "mixed":
        qv = np.arange(16, dtype=np.int32) * 7 + 10
        jq, tq = jnp.asarray(qv), torch.from_numpy(qv)
    else:
        jq = tq = quota
    ji, jd, jc = jv.search(jidx, jnp.asarray(x), jnp.asarray(q), k=10,
                           beam_width=48, quota=jq)
    ti, td, tc = tv.search(tidx, torch.from_numpy(x), torch.from_numpy(q),
                           k=10, beam_width=48, quota=tq, device="cpu")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-5)
    if quota is None:
        em = tdist.EmbeddingMetric(torch.from_numpy(x))
        true_ids, _ = em.brute_force(torch.from_numpy(q), 10)
        jtrue, _ = jdist.EmbeddingMetric(jnp.asarray(x)).brute_force(
            jnp.asarray(q), 10)
        np.testing.assert_array_equal(true_ids.numpy(), np.asarray(jtrue))
        assert float(tmetrics.recall_at_k(ti, true_ids).mean()) >= 0.9


def test_search_from_converted_index_and_matmul(built):
    """A graph handed across as numpy searches identically; the norm-cache
    form finds the same neighbours."""
    x, jidx, _ = built
    idx = index_from_numpy(np.asarray(jidx.adjacency), jidx.medoid,
                           jidx.config, device="cpu")
    q = torch.from_numpy(x[:8] + 0.01)
    ids, _, calls = tv.search(idx, torch.from_numpy(x), q, k=10,
                              device="cpu")
    jids, _, jcalls = jv.search(jidx, jnp.asarray(x), jnp.asarray(x[:8] + 0.01),
                                k=10)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(calls.numpy(), np.asarray(jcalls))
    mids, _, _ = tv.search(idx, torch.from_numpy(x), q, k=10,
                           backend="matmul", device="cpu")
    assert (mids.numpy() == ids.numpy()).mean() >= 0.99
    with pytest.raises(ValueError, match="search_mesh"):
        tv.search(idx, torch.from_numpy(x), q, k=10, shards=2, device="cpu")


def test_robust_prune_alpha_property(built):
    """Every pruned candidate has a kept neighbour c with
    alpha·d(c, j) <= d(p, j) (Definition 3.1 on the pool)."""
    x, _, _ = built
    xt = torch.from_numpy(x)
    rng = np.random.default_rng(3)
    p = 5
    pool = torch.from_numpy(rng.choice(N, 64, replace=False).astype(np.int32))
    em = tdist.EmbeddingMetric(xt)
    d = em.dists(xt[p], pool)
    order = torch.argsort(d, stable=True)
    pool, d = pool[order], d[order]
    sel = tv.robust_prune(torch.tensor([p], dtype=torch.int32), pool[None],
                          d[None], xt, alpha=1.2, max_degree=64,
                          metric="l2")[0].numpy()
    kept = sel[sel >= 0]
    for qi, dq in zip(pool.numpy(), d.numpy()):
        if qi == p or qi in kept:
            continue
        assert any(1.2 * np.linalg.norm(x[c] - x[qi]) <= dq + 1e-4
                   for c in kept), qi
