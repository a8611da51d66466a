"""The hand-written Hopper kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one; this file imports
no JAX, so it runs on a machine with the card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import beam, distances
from repro_torch.kernels import backend, l2_topk, ops

METRICS = ["l2", "sqeuclidean", "ip", "cosine"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _gather_inputs(seed, n=300, dim=384, b=4, k=70):
    g = torch.Generator().manual_seed(seed)
    corpus = torch.randn(n, dim, generator=g)
    corpus[5] = 0.0
    qs = torch.randn(b, dim, generator=g)
    ids = torch.randint(-1, n, (b, k), generator=g, dtype=torch.int32)
    ids[:, 0] = 5
    return corpus, qs, ids


def _to(view, dev):
    return backend.CorpusView(*(None if f is None else f.to(dev)
                                for f in view))


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("rows", ["float32", "bfloat16", "float16", "int8",
                                  "fp8", "fp8_e5m2"])
def test_gather_kernel_vs_plain(dev, metric, rows):
    corpus, qs, ids = _gather_inputs(seed=len(metric) + len(rows))
    if rows in ("float32", "bfloat16", "float16"):
        view = backend.as_corpus_view(corpus.to(getattr(torch, rows)))
    else:
        view = backend.as_corpus_view(corpus, quantize=rows)
    gview = _to(view, dev)
    for be in ("ref", "matmul"):
        want = ops.gather_score(view, qs, ids, metric=metric, backend=be)
        got = ops.gather_score(gview, qs.to(dev), ids.to(dev), metric=metric,
                               backend=be).cpu()
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        assert torch.isinf(got[ids < 0]).all()
        if metric == "cosine":
            assert (got[:, 0] == 1.0).all()


@pytest.mark.cuda
def test_gather_lane_value_is_position_free(dev):
    """A lane's value depends only on its (query, row) pair."""
    corpus, qs, ids = _gather_inputs(seed=3, dim=4096, b=3, k=33)
    c, q, i = corpus.to(dev), qs.to(dev), ids.to(dev)
    full = l2_topk.gather_score(c, q, i, metric="l2")
    for b in range(3):
        for k in (0, 7, 32):
            one = l2_topk.gather_score(c, q[b:b + 1].contiguous(),
                                       i[b:b + 1, k:k + 1].contiguous(),
                                       metric="l2")
            assert torch.equal(one[0, 0], full[b, k])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(256, 64), (500, 64), (1000, 500)])
def test_merge_kernel_vs_plain(dev, shape):
    p, k = shape
    g = torch.Generator().manual_seed(p + k)
    b = 6
    pi = torch.randint(0, 10_000, (b, p), generator=g, dtype=torch.int32)
    pd = torch.sort(torch.randint(0, 50, (b, p), generator=g).float(), 1).values
    pd[:, -5:] = float("inf")
    pi[:, -5:] = -1
    pf = torch.rand(b, p, generator=g) < 0.5
    ci = torch.randint(-1, 10_000, (b, k), generator=g, dtype=torch.int32)
    cd = torch.randint(0, 50, (b, k), generator=g).float()
    cd[ci < 0] = float("inf")
    ci[1], cd[1] = -1, float("inf")  # an all-masked wave
    cd[2, 0] = -0.0
    want = ops.merge_pool_batch(pi, pd, pf, ci, cd)
    before = l2_topk.launches["beam_merge_topk"]
    got = ops.merge_pool_batch(*(a.to(dev) for a in (pi, pd, pf, ci, cd)))
    assert l2_topk.launches["beam_merge_topk"] == before + 1
    for w, x in zip(want, got):
        assert torch.equal(x.cpu(), w)
    assert torch.equal(got[0][1].cpu(), pi[1])
    half = ops.merge_pool_batch(pi.to(dev), pd.to(dev).half(), pf.to(dev),
                                ci.to(dev), cd.to(dev).half())
    assert half[1].dtype == torch.float16


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    corpus, qs, ids = _gather_inputs(seed=1)
    c, q = corpus.to(dev), qs.to(dev)
    with pytest.raises(ValueError):
        l2_topk.gather_score(c, q, ids.to(dev).long())
    with pytest.raises(ValueError):
        l2_topk.gather_score(c.t(), q, ids.to(dev))
    big = torch.zeros((1, l2_topk.MAX_MERGE_PAD), dtype=torch.int32,
                      device=dev)
    with pytest.raises(ValueError):
        l2_topk.beam_merge_topk(big, big.float(), big[:, :1], big[:, :1].float())


@pytest.mark.cuda
def test_search_batch_matches_single_on_card(dev):
    rng = np.random.default_rng(2)
    n = 300
    adj = torch.from_numpy(rng.integers(0, n, (n, 12)).astype(np.int32))
    emb = torch.from_numpy(rng.normal(size=(n, 384)).astype(np.float32))
    qs = torch.from_numpy(rng.normal(size=(6, 384)).astype(np.float32))
    em = distances.EmbeddingMetric(emb.to(dev))
    entries = torch.zeros((6, 1), dtype=torch.int32, device=dev)
    kw = dict(n_points=n, beam_width=16, pool_size=32, quota=60,
              max_steps=200)
    batched = beam.batched_greedy_search(em.dists_batch, adj.to(dev),
                                         qs.to(dev), entries, **kw)
    for b in range(6):
        single = beam.batched_greedy_search(
            em.dists_batch, adj.to(dev), qs[b:b + 1].to(dev),
            entries[b:b + 1], **kw)
        for x, y in zip(batched, single):
            assert torch.equal(x[b], y[0])
    cpu = beam.batched_greedy_search(
        distances.EmbeddingMetric(emb).dists_batch, adj, qs,
        entries.cpu(), **kw)
    assert torch.equal(cpu.n_calls, batched.n_calls.cpu())
