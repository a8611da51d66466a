"""The port's scatter-gather search over per-shard sub-indices, on the CPU.

Port only (no JAX here; ``tests/test_torch_sharding.py``'s subprocess holds
it against JAX's ``sharded_bimetric_search`` on four host devices):

* ``ops.local_topk``: clamped to the width, padded with (-1, +inf), ties to
  the lowest index, the distances' dtype kept;
* ``collectives.gather_topk_merge`` against a stable sort of the shards'
  pools laid side by side, ties to the lower shard;
* the ring matmuls against the dense product, and the reduce-scatter's
  order of adds;
* ``build_sharded``: shard s is ``vamana.build`` of block s, its rows views
  of the corpus; a row count that does not divide raises;
* ``sharded_bimetric_search``: the per-shard searches merged, the
  reference's ``quota < k·S`` fact, and recall@10 >= 0.7 at the JAX test's
  shapes (``tests/test_distributed.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import distances, metrics, vamana
from repro_torch.core import distributed as dist
from repro_torch.data.synthetic import make_dataset
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import search_mesh
from repro_torch.kernels import ops

CPU = "cpu"
# tests/test_distributed.py's sharded-search config
CFG = vamana.VamanaConfig(max_degree=12, l_build=16, pool_size=32,
                          rev_candidates=12, build_batch=256)


def _mesh(s):
    return search_mesh(s, devices=[CPU] * s)


def _stable_topk(ids, dists, k):
    """numpy reference: a stable sort on f32 keys, padded to k."""
    order = np.argsort(np.asarray(dists, np.float32), axis=1,
                       kind="stable")[:, :k]
    out_i = np.take_along_axis(ids, order, 1)
    out_d = np.take_along_axis(np.asarray(dists, np.float32), order, 1)
    pad = k - out_i.shape[1]
    if pad > 0:
        out_i = np.pad(out_i, ((0, 0), (0, pad)), constant_values=-1)
        out_d = np.pad(out_d, ((0, 0), (0, pad)), constant_values=np.inf)
    return out_i, out_d


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("k", [3, 7, 12])
def test_local_topk_ties_pad_and_dtype(dtype, k):
    """Width 7: k = 3 cuts, k = 7 keeps all, k = 12 pads five (-1, +inf)
    lanes. Distances on a coarse grid tie often; ties keep the lower index;
    +inf lanes sort last; the dtype stays."""
    rng = np.random.default_rng(k)
    d = rng.integers(0, 4, (5, 7)).astype(np.float32)
    d[0, 2] = np.inf
    ids = rng.integers(0, 100, (5, 7)).astype(np.int32)
    got_i, got_d = ops.local_topk(torch.from_numpy(ids),
                                  torch.from_numpy(d).to(dtype), k)
    want_i, want_d = _stable_topk(ids, d, k)
    assert got_d.dtype == dtype and got_i.dtype == torch.int32
    assert got_i.shape == (5, k)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_array_equal(got_d.float().numpy(), want_d)


@pytest.mark.parametrize("k", [4, 10])
def test_gather_topk_merge_is_a_stable_sort_of_the_shards(k):
    """Four shards of width 6 (k = 10 pads each shard's cut) with ties
    inside and across shards: the merge equals a stable sort of the pools
    side by side in shard order, so a tie goes to the lower shard."""
    rng = np.random.default_rng(k)
    s, b, w = 4, 3, 6
    d = rng.integers(0, 5, (s, b, w)).astype(np.float32)
    d[1, 0] = np.inf
    ids = (np.arange(s)[:, None, None] * 100
           + rng.integers(0, 100, (s, b, w))).astype(np.int32)
    got_i, got_d = collectives.gather_topk_merge(
        [torch.from_numpy(i) for i in ids], [torch.from_numpy(x) for x in d],
        k)
    want_i, want_d = _stable_topk(np.concatenate(list(ids), 1),
                                  np.concatenate(list(d), 1), k)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_array_equal(got_d.numpy(), want_d)


def test_ring_matmuls_match_the_dense_product():
    """tests/test_distributed.py's shapes, over four shards: within 1e-4 of
    the dense product; every shard's all-gathered product is the same; block
    c of the reduce-scatter adds the shards' partials in the ring's order
    c + 1, c + 2, ..., c."""
    g = torch.Generator().manual_seed(0)
    x, w = torch.randn(16, 12, generator=g), torch.randn(12, 10, generator=g)
    xs = list(x.chunk(4))
    outs = collectives.allgather_matmul(xs, [w] * 4)
    assert all(torch.equal(o, outs[0]) for o in outs)
    assert (outs[0] - x @ w).abs().max() < 1e-4
    xk, wk = torch.randn(16, 24, generator=g), torch.randn(24, 10, generator=g)
    xks, wks = list(xk.chunk(4, dim=1)), list(wk.chunk(4))
    blocks = collectives.matmul_reducescatter(xks, wks)
    assert (torch.cat(blocks) - xk @ wk).abs().max() < 1e-4
    for c in range(4):
        acc = torch.zeros(4, 10)
        for j in range(1, 5):
            sh = (c + j) % 4
            acc = acc + xks[sh][4 * c:4 * c + 4] @ wks[sh]
        assert torch.equal(blocks[c], acc)
    with pytest.raises(ValueError, match="divide"):
        collectives.matmul_reducescatter([xk[:15, :6]] * 4, wks)


@pytest.fixture(scope="module")
def data():
    return make_dataset(n=1024, n_queries=16, dim_D=48, dim_d=8, noise=0.1,
                        seed=2, device=CPU)


@pytest.fixture(scope="module")
def index(data):
    return dist.build_sharded(data.corpus_d, data.corpus_D, 4, CFG,
                              mesh=_mesh(4))


def test_build_sharded_is_a_graph_per_block(data, index):
    """Shard s is ``vamana.build`` on rows [64 s, 64 (s + 1)) with d (the
    first 256 rows, four shards); its rows are views of the corpus; the
    numpy round trip gives the same index; a row count that does not
    divide raises."""
    cd, cD = data.corpus_d[:256], data.corpus_D[:256]
    small = dist.build_sharded(cd, cD, 4, CFG, device=CPU)
    assert small.n_shards == 4 and small.n_local == 64
    for s in range(4):
        want = vamana.build(cd[64 * s:64 * (s + 1)], CFG, device=CPU)
        assert torch.equal(small.adjacency[s], want.adjacency)
        assert small.medoid[s] == want.medoid
        for rows, full in ((small.emb_cheap[s], cd), (small.emb_expensive[s],
                                                      cD)):
            assert rows.untyped_storage().data_ptr() == (
                full.untyped_storage().data_ptr())
            assert torch.equal(rows, full[64 * s:64 * (s + 1)])
    assert index.n_shards == 4 and index.n_local == 256
    stacked = lambda ts: np.stack([t.numpy() for t in ts])
    back = convert.sharded_index_from_numpy(
        stacked(index.adjacency), np.array(index.medoid),
        stacked(index.emb_cheap), stacked(index.emb_expensive), CFG,
        device=CPU)
    assert back.medoid == index.medoid and back.config == CFG
    for field in ("adjacency", "emb_cheap", "emb_expensive"):
        assert all(torch.equal(a, b) for a, b in zip(
            getattr(back, field), getattr(index, field)))
    with pytest.raises(ValueError, match="divide"):
        dist.build_sharded(data.corpus_d[:1022], data.corpus_D[:1022], 4,
                           CFG, device=CPU)


def test_sharded_search_merges_the_shards(data, index):
    """Each shard searched alone (``_local_search`` at the per-shard quota
    and seeds), its ids made global, its invalid lanes +inf, and the
    shards' lists stable-sorted side by side: the entry point's answer.
    The D calls are the shards' sum, each shard within its quota."""
    quota, k = 96, 10
    ids, dists, calls = dist.sharded_bimetric_search(
        _mesh(4), index, data.queries_d, data.queries_D, quota=quota, k=k)
    per, total, lists = max(k, quota // 4), 0, []
    for s in range(4):
        li, ld, lc = dist._local_search(
            index.adjacency[s], index.medoid[s], index.emb_cheap[s],
            index.emb_expensive[s], data.queries_d, data.queries_D,
            quota=per, k=k, n_seeds=per // 2, cfg=CFG, device=CPU)
        assert (lc <= per).all()
        total = total + lc
        gi = np.where(li.numpy() >= 0, li.numpy() + 256 * s, -1)
        lists.append((gi, np.where(gi >= 0, ld.numpy(), np.inf)))
    want_i, want_d = _stable_topk(np.concatenate([g for g, _ in lists], 1),
                                  np.concatenate([d for _, d in lists], 1), k)
    np.testing.assert_array_equal(ids.numpy(), want_i)
    np.testing.assert_array_equal(dists.numpy(), want_d)
    assert torch.equal(calls, total)
    assert ids.dtype == torch.int32 and calls.dtype == torch.int32


def test_quota_below_k_times_shards_is_the_references_fact(data, index):
    """quota = 20 < k·S = 40: each shard's quota is max(k, 20 // 4) = 10,
    so a query may pay up to 40 D calls, as JAX's program does. Pinned,
    not a fault."""
    _, _, calls = dist.sharded_bimetric_search(
        _mesh(4), index, data.queries_d, data.queries_D, quota=20, k=10)
    assert int(calls.max()) > 20
    assert int(calls.max()) <= 40


def test_sharded_search_recall(data, index):
    """tests/test_distributed.py's check: quota 256 over four shards reaches
    recall@10 >= 0.7 of the exact D ranking, every query within 256 D
    calls."""
    ids, dists, calls = dist.sharded_bimetric_search(
        _mesh(4), index, data.queries_d, data.queries_D, quota=256, k=10)
    true_ids, _ = distances.EmbeddingMetric(data.corpus_D).brute_force(
        data.queries_D, 10)
    rec = float(metrics.recall_at_k(ids, true_ids).mean())
    assert rec >= 0.7, rec
    assert int(calls.max()) <= 256
    assert torch.isfinite(dists).all()
    with pytest.raises(ValueError, match="mesh"):
        dist.sharded_bimetric_search(_mesh(2), index, data.queries_d,
                                     data.queries_D, quota=256)
