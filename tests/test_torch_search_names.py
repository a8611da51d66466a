"""The search modules' smaller public names against their JAX originals.

The same numpy inputs through both packages, on one CPU device:
``beam.greedy_search`` (one query) and ``greedy_search_batch`` on
``tests/test_beam.py``'s line graphs (every field exact);
``distances.point_to_points`` and ``dist_fn_from_embeddings``
(``tests/test_distances.py``); the sqeuclidean gather entries
``ref.l2_gather_dists_ref``, ``ops.gather_l2`` and ``l2_topk.gather_l2``
(``tests/test_kernels.py``'s sweep shapes and tolerance, JAX's Pallas
kernel in interpret mode); and ``l2_topk.pack_norms``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import beam as jbeam
from repro.core import distances as jdist
from repro.kernels import backend as jbackend
from repro.kernels import l2_topk as jl2
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import beam as tbeam
from repro_torch.core import distances as tdist
from repro_torch.kernels import backend as tbackend
from repro_torch.kernels import l2_topk as tl2
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

METRICS = ["l2", "sqeuclidean", "ip", "cosine"]


def _line_graph(n):
    """tests/test_beam.py's path graph 0-1-...-n-1, embeddings on a line."""
    adj = np.full((n, 4), -1, np.int32)
    for i in range(n):
        if i > 0:
            adj[i, 0] = i - 1
        if i < n - 1:
            adj[i, 1] = i + 1
    return adj, np.arange(n, dtype=np.float32)[:, None]


def _same(got, want):
    for name, a, b in zip(want._fields, want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)


# tests/test_beam.py's searches (n, query, entries, knobs); its first, the
# 32-line from entry 0 to 27.2, is a row of the batch test below
GREEDY = [
    (64, 63.0, [0], dict(beam_width=4, quota=5, max_steps=500)),
    (16, 8.0, [0, 0, 15, 3], dict(beam_width=6, max_steps=100)),
    (16, 8.0, list(range(10)), dict(beam_width=6, quota=4, max_steps=100)),
]


@pytest.mark.parametrize("n,q,entries,kw", GREEDY)
def test_greedy_search_matches_jax(n, q, entries, kw):
    adj, emb = _line_graph(n)
    qv = np.array([q], np.float32)
    jem = jdist.EmbeddingMetric(jnp.asarray(emb))
    tem = tdist.EmbeddingMetric(torch.from_numpy(emb))
    want = jbeam.greedy_search(
        lambda ids: jem.dists(jnp.asarray(qv), ids), jnp.asarray(adj),
        jnp.asarray(entries, jnp.int32), n_points=n, **kw)
    got = tbeam.greedy_search(
        lambda ids: tem.dists(torch.from_numpy(qv), ids),
        torch.from_numpy(adj), torch.tensor(entries, dtype=torch.int32),
        n_points=n, **kw)
    _same(got, want)
    assert int(got.scored.sum()) == int(got.n_calls)


@pytest.mark.parametrize("entries", [[0], [[0], [31], [16]]])
def test_greedy_search_batch_matches_jax(entries):
    """A per-query distance function over three queries; entries (E,) for
    every query, or (B, E)."""
    adj, emb = _line_graph(32)
    qs = np.array([[27.2], [3.5], [16.0]], np.float32)
    jem = jdist.EmbeddingMetric(jnp.asarray(emb))
    tem = tdist.EmbeddingMetric(torch.from_numpy(emb))
    kw = dict(n_points=32, beam_width=4, quota=9, max_steps=100)
    want = jbeam.greedy_search_batch(jem.dists, jnp.asarray(adj),
                                     jnp.asarray(qs),
                                     jnp.asarray(entries, jnp.int32), **kw)
    got = tbeam.greedy_search_batch(tem.dists, torch.from_numpy(adj),
                                    torch.from_numpy(qs),
                                    torch.tensor(entries, dtype=torch.int32),
                                    **kw)
    _same(got, want)


@pytest.mark.parametrize("metric", METRICS)
def test_point_to_points_and_dist_fn_match_jax(metric):
    rng = np.random.default_rng(len(metric))
    x = rng.normal(size=(11, 5)).astype(np.float32)
    q = rng.normal(size=(5,)).astype(np.float32)
    want = jdist.point_to_points(jnp.asarray(q), jnp.asarray(x), metric)
    got = tdist.point_to_points(torch.from_numpy(q), torch.from_numpy(x),
                                metric)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    ids = np.array([0, -1, 3, 10, 3], np.int32)
    want = jdist.dist_fn_from_embeddings(jnp.asarray(x), metric)(
        jnp.asarray(q), jnp.asarray(ids))
    got = tdist.dist_fn_from_embeddings(torch.from_numpy(x), metric)(
        torch.from_numpy(q), torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    assert np.isinf(got.numpy()[1])


@pytest.mark.parametrize("n,dim,b,k", [(200, 64, 4, 16), (64, 128, 2, 8),
                                       (100, 32, 8, 32)])
def test_gather_l2_entries_match_jax(n, dim, b, k):
    """The port's three sqeuclidean entries against JAX's oracle, its
    ``ops.gather_l2`` (ref backend) and, at the first shape, its Pallas
    ``l2_topk.gather_l2`` in interpret mode, within tests/test_kernels.py's
    1e-4; padding lanes +inf."""
    rng = np.random.default_rng(n + dim)
    corpus = rng.normal(size=(n, dim)).astype(np.float32)
    qs = rng.normal(size=(b, dim)).astype(np.float32)
    ids = rng.integers(-1, n, (b, k)).astype(np.int32)
    jargs = [jnp.asarray(a) for a in (corpus, qs, ids)]
    targs = [torch.from_numpy(a) for a in (corpus, qs, ids)]
    want = np.asarray(jref.l2_gather_dists_ref(*jargs))
    finite = np.isfinite(want)
    assert (finite == (ids >= 0)).all()
    pairs = [(tref.l2_gather_dists_ref(*targs), want),
             (tops.gather_l2(*targs), np.asarray(jops.gather_l2(*jargs))),
             (tl2.gather_l2(*targs), want)]
    if n == 200:  # one Pallas run in interpret mode is enough
        pairs.append((tl2.gather_l2(*targs),
                      np.asarray(jl2.gather_l2(*jargs, interpret=True))))
    for got, ref in pairs:
        got = got.numpy()
        np.testing.assert_allclose(got[finite], ref[finite], rtol=1e-4,
                                   atol=1e-4)
        assert (np.isinf(got) == ~finite).all()


def test_pack_norms_matches_jax():
    rng = np.random.default_rng(5)
    corpus = rng.normal(size=(90, 32)).astype(np.float32)
    corpus[3] = 0.0
    want = jl2.pack_norms(jbackend.as_corpus_view(jnp.asarray(corpus)))
    got = tl2.pack_norms(tbackend.as_corpus_view(torch.from_numpy(corpus)))
    assert got.shape == (90, 2) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    view = tbackend.as_corpus_view(torch.from_numpy(corpus))
    assert torch.equal(got, tl2.pack_row_meta(view))


def test_member_lookup_and_insert_match_jax():
    """``collectives.member_lookup`` / ``member_insert`` on a replicated
    sorted set (pads, duplicate lanes, negative ids, unmarked lanes)
    against JAX's (their ``axis_name`` names no collective): the lookup
    and the merged rows exact; ``beam``'s dedup step calls them."""
    from repro.distributed import collectives as jcoll
    from repro_torch.distributed import collectives as tcoll

    rng = np.random.default_rng(5)
    b, c, k = 4, 12, 6
    pad = int(jops.SET_PAD)
    assert pad == int(tops.SET_PAD)
    set_ids = np.full((b, c), pad, np.int32)
    for r in range(b):
        held = np.sort(rng.choice(40, size=r + 2, replace=False))
        set_ids[r, :held.size] = held
    ids = rng.integers(-1, 40, (b, k)).astype(np.int32)
    ids[0, 1] = ids[0, 0]  # a duplicate lane
    ids[1, :2] = set_ids[1, :2]  # already held
    mark = rng.random((b, k)) < 0.6
    got = tcoll.member_lookup(torch.from_numpy(set_ids), torch.from_numpy(ids))
    want = jcoll.member_lookup(jnp.asarray(set_ids), jnp.asarray(ids),
                               axis_name="x")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = tcoll.member_insert(torch.from_numpy(set_ids),
                              torch.from_numpy(ids), torch.from_numpy(mark))
    want = jcoll.member_insert(jnp.asarray(set_ids), jnp.asarray(ids),
                               jnp.asarray(mark), axis_name="x")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_backend_ref_and_embed_query_match_jax():
    """``backend.REF`` is JAX's: the ``ref`` form, no residency; and
    ``EmbeddingMetric.embed_query`` returns the query as it is, as JAX's
    precomputed-embedding metric does."""
    assert tbackend.REF == tbackend.resolve_backend("ref")
    assert (tbackend.REF.name, tbackend.REF.quantize) == (
        jbackend.REF.name, jbackend.REF.quantize)
    q = np.linspace(-1.0, 1.0, 8, dtype=np.float32)
    emb = np.ones((5, 8), np.float32)
    got = tdist.EmbeddingMetric(torch.from_numpy(emb)).embed_query(
        torch.from_numpy(q))
    want = jdist.EmbeddingMetric(jnp.asarray(emb)).embed_query(jnp.asarray(q))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
