"""The hand-written Hopper kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one; this file imports
no JAX, so it runs on a machine with the card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import beam, covertree, distances
from repro_torch.distributed import sharding
from repro_torch.kernels import (backend, embedding_bag, flash_attention,
                                 l2_topk, ops, ref)

METRICS = ["l2", "sqeuclidean", "ip", "cosine"]
# kernel vs plain: the JAX kernel tests' tolerances (2e-5 f32, 2e-2 bf16,
# 1e-5 for the bag in f32); f16 within its own rounding
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2, torch.float16: 2e-3}
BAG_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2, torch.float16: 2e-3}


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


def _bit_equal(a, b):
    """torch.equal, with f32 compared bit for bit (NaN equals its own copy,
    -0.0 differs from +0.0)."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def _merge_rows(seed, b, p, k, order):
    """A (B, P) pool and (B, K) wave: ``sorted`` as the engine hands it in,
    ``unsorted`` (a shuffled pool), or ``zeros_nan`` (signed zeros and NaN in
    both runs, the pool still sorted in the kernel's key order)."""
    g = torch.Generator().manual_seed(seed)
    pi = torch.randint(0, 10_000, (b, p), generator=g, dtype=torch.int32)
    pd = torch.sort(torch.randint(0, 30, (b, p), generator=g).float(), 1).values
    pf = torch.rand(b, p, generator=g) < 0.5
    ci = torch.randint(0, 10_000, (b, k), generator=g, dtype=torch.int32)
    cd = torch.randint(0, 30, (b, k), generator=g).float()
    if order == "unsorted":
        perm = torch.argsort(torch.rand(b, p, generator=g), 1)
        pi, pd, pf = pi.gather(1, perm), pd.gather(1, perm), pf.gather(1, perm)
    elif order == "zeros_nan":
        pd[:, : p // 2] = -0.0
        pd[:, p // 2: p // 2 + 1] = 0.0
        pd[:, -1] = float("nan")
        cd[:, ::2] = 0.0
        cd[:, 1::3] = -0.0
        cd[:, ::5] = float("nan")
    return pi, pd, pf, ci, cd


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["sorted", "unsorted", "zeros_nan"])
@pytest.mark.parametrize("p,k", [(100, 37), (20, 77), (1, 1), (300, 212),
                                 (1000, 64)])
def test_merge_kernel_edge_rows(dev, p, k, order):
    """K > P, P + K no power of two, one lane, an unsorted pool (the full
    network) and NaN / signed zeros: torch.equal to the stable oracle."""
    rows = _merge_rows(p * 7 + k, 4, p, k, order)
    want = ref.merge_pool_batch_ref(*rows)
    got = ops.merge_pool_batch(*(a.to(dev) for a in rows))
    for w, x in zip(want, got):
        assert _bit_equal(x.cpu(), w)
    pi, pd, _, ci, cd = rows
    want = ref.beam_merge_topk_ref(pi, pd, ci, cd)
    got = ops.beam_merge_topk(pi.to(dev), pd.to(dev), ci.to(dev), cd.to(dev))
    for w, x in zip(want, got):
        assert _bit_equal(x.cpu(), w)


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


def _local_blocks(view, shards):
    """Shard s's (rows, meta) of a view, placed as the sharded engine
    places it."""
    st = sharding.shard_corpus_view(view, shards)
    blocks = []
    for s in range(shards):
        v = backend.CorpusView(
            rows=st[0][s], sq_norms=st[1][s], inv_norms=st[2][s],
            scales=st[3][s] if view.scales is not None else None,
            zero_points=st[4][s] if view.zero_points is not None else None)
        blocks.append((v.rows, l2_topk.pack_row_meta(v)))
    return blocks, st[-1]


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [3, 4])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("rows", ["float32", "bfloat16", "int8", "fp8",
                                  "fp8_e5m2"])
def test_gather_local_kernel_vs_plain(dev, rows, metric, shards):
    """At every shard's offset: owned lanes agree with the plain version and
    equal the gather_score kernel's lanes bit for bit; foreign and padding
    lanes are exactly 0.0; the shards' sum is the unsharded wave."""
    corpus, qs, ids = _gather_inputs(seed=len(rows) + len(metric) + shards,
                                     n=301)
    if rows in ("float32", "bfloat16"):
        view = backend.as_corpus_view(corpus.to(getattr(torch, rows)))
    else:
        view = backend.as_corpus_view(corpus, quantize=rows)
    gview = _to(view, dev)
    blocks, n_local = _local_blocks(gview, shards)
    q, i = qs.to(dev), ids.to(dev)
    meta = l2_topk.pack_row_meta(gview)
    forms = [(False, None if view.scales is None else meta), (True, meta)]
    for mm, m in forms:
        full = l2_topk.gather_score(gview.rows, q, i, metric=metric, meta=m,
                                    matmul=mm)
        total = None
        for s, (r, bm) in enumerate(blocks):
            off = s * n_local
            bm = bm if m is not None else None
            before = l2_topk.launches["gather_score_local"]
            got = l2_topk.gather_score_local(r, q, i, off, metric=metric,
                                             meta=bm, matmul=mm)
            assert l2_topk.launches["gather_score_local"] == before + 1
            want = l2_topk.gather_score_local_plain(
                r.cpu(), qs, ids, off, metric=metric,
                meta=None if bm is None else bm.cpu(), matmul=mm)
            owned = (i >= 0) & (i - off >= 0) & (i - off < n_local)
            assert (got[~owned] == 0.0).all()
            assert torch.equal(got[owned], full[owned])
            torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
            total = got if total is None else total + got
        total = torch.where(i >= 0, total, torch.inf)
        assert torch.equal(total, full)


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("k", [1, 63, 64, 65, 256, 257, 1000])
def test_gather_local_owned_lanes_any_width(dev, k, shards):
    """Waves one lane wide to four chunks of 256 lanes, at 1 to 8 shards,
    every form and row type: owned lanes torch.equal to gather_score,
    every other lane +0.0, and the shards' sum the unsharded wave."""
    corpus, qs, ids = _gather_inputs(seed=k + shards, n=301, dim=64, b=3, k=k)
    metric = METRICS[(k + shards) % 4]
    q, i = qs.to(dev), ids.to(dev)
    for rows in ("float32", "bfloat16", "float16", "int8", "fp8",
                 "fp8_e5m2"):
        if rows in ("float32", "bfloat16", "float16"):
            view = backend.as_corpus_view(corpus.to(getattr(torch, rows)))
        else:
            view = backend.as_corpus_view(corpus, quantize=rows)
        gview = _to(view, dev)
        blocks, n_local = _local_blocks(gview, shards)
        meta = l2_topk.pack_row_meta(gview)
        for mm, m in ((False, None if view.scales is None else meta),
                      (True, meta)):
            full = l2_topk.gather_score(gview.rows, q, i, metric=metric,
                                        meta=m, matmul=mm)
            total = None
            for s, (r, bm) in enumerate(blocks):
                off = s * n_local
                got = l2_topk.gather_score_local(
                    r, q, i, off, metric=metric,
                    meta=bm if m is not None else None, matmul=mm)
                owned = (i >= 0) & (i - off >= 0) & (i - off < n_local)
                assert (got[~owned].view(torch.int32) == 0).all(), rows
                assert torch.equal(got[owned], full[owned]), rows
                total = got if total is None else total + got
            total = torch.where(i >= 0, total, torch.inf)
            assert torch.equal(total, full), (rows, mm)


@pytest.mark.cuda
@pytest.mark.parametrize("wave", ["foreign", "padding"])
def test_gather_local_wave_with_no_owned_lane(dev, wave):
    """Every block leaves before staging its query: the output is all +0.0
    (bit for bit), and the launch counts once."""
    corpus, qs, ids = _gather_inputs(seed=9, n=400, b=5, k=700)
    c, q = corpus.to(dev), qs.to(dev)
    # shard 1 of 2 owns rows [200, 400); this wave reads rows < 200 only
    i = (ids.clamp(min=0) % 200 if wave == "foreign"
         else torch.full_like(ids, -1)).to(dev)
    before = l2_topk.launches["gather_score_local"]
    out = l2_topk.gather_score_local(c[200:], q, i, 200, metric="l2")
    assert l2_topk.launches["gather_score_local"] == before + 1
    assert out.shape == (5, 700)
    assert (out.view(torch.int32) == 0).all()


@pytest.mark.cuda
def test_gather_local_refuses_a_misaligned_block(dev):
    flat = torch.zeros(300 * 384 + 1, device=dev)
    rows = flat[1:].view(300, 384)  # 4 bytes past a 16-byte boundary
    q = torch.zeros((2, 384), device=dev)
    ids = torch.zeros((2, 3), dtype=torch.int32, device=dev)
    for fn in (lambda: l2_topk.gather_score(rows, q, ids),
               lambda: l2_topk.gather_score_local(rows, q, ids, 0)):
        with pytest.raises(ValueError, match="aligned"):
            fn()


@pytest.mark.cuda
@pytest.mark.parametrize("backend_", [("ref", None), ("matmul", "int8")])
def test_sharded_search_matches_unsharded_on_card(dev, backend_):
    """N=2048: sharded_greedy_search at S=4 on one card equals shards=1 on
    every field, and launches the shard-local kernel S times a wave."""
    be, quant = backend_
    rng = np.random.default_rng(4)
    n, b = 2048, 8
    adj = torch.from_numpy(rng.integers(0, n, (n, 16)).astype(np.int32))
    emb = torch.from_numpy(rng.normal(size=(n, 384)).astype(np.float32))
    qs = torch.from_numpy(rng.normal(size=(b, 384)).astype(np.float32))
    entries = torch.zeros((b, 1), dtype=torch.int32)
    kw = dict(metric="l2", beam_width=32, pool_size=32, quota=200,
              max_steps=300, backend=be, quantize=quant)
    base = beam.sharded_greedy_search(emb.to(dev), adj, qs, entries,
                                      shards=1, device=dev, **kw)
    l2_topk.reset_launches()
    mesh = sharding.search_mesh(4, devices=[dev] * 4)
    got = beam.sharded_greedy_search(emb.to(dev), adj, qs, entries, shards=4,
                                     mesh=mesh, **kw)
    for name, x, y in zip(got._fields, base, got):
        assert torch.equal(x, y), name
    waves = l2_topk.launches["beam_merge_topk"]
    assert waves > 1 and l2_topk.launches["gather_score"] == 0
    assert l2_topk.launches["gather_score_local"] == 4 * waves


def _randn(g, *shape, dtype=torch.float32):
    return torch.randn(*shape, generator=g).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,sq,skv,dh,dv,causal,dtype", [
    (2, 4, 128, 128, 64, 64, True, torch.float32),
    (1, 2, 96, 96, 32, 32, True, torch.float32),
    (2, 2, 64, 256, 32, 32, False, torch.float32),
    (1, 1, 128, 128, 128, 128, True, torch.bfloat16),
    (1, 2, 33, 65, 16, 16, True, torch.float32),
    (1, 2, 64, 64, 48, 32, True, torch.float32),       # dv != dh
    (1, 2, 70, 70, 192, 128, True, torch.bfloat16),    # MLA widths
    (2, 1, 100, 37, 64, 64, True, torch.float32),      # Sq > Skv: 63 empty rows
    (1, 2, 50, 80, 256, 256, False, torch.float16),    # widest head
    # the tensor-core route's edges: lengths no multiple of 64 or 128,
    # Sq > Skv causal, non-causal, 192/128, 256, a head padded from 24, the
    # smoke configs' 16 and 8; and a 16-bit head of 20 (the SIMT route)
    (2, 3, 70, 70, 128, 128, True, torch.bfloat16),
    (2, 3, 70, 70, 128, 128, True, torch.float16),
    (2, 1, 100, 37, 128, 128, True, torch.bfloat16),
    (2, 1, 300, 37, 64, 64, True, torch.float16),
    (1, 2, 100, 37, 64, 64, False, torch.bfloat16),
    (1, 2, 200, 333, 128, 128, False, torch.float16),
    (1, 2, 300, 300, 192, 128, True, torch.float16),
    (1, 2, 300, 300, 256, 256, True, torch.bfloat16),
    (2, 2, 257, 257, 24, 24, True, torch.bfloat16),
    (1, 2, 130, 130, 16, 16, True, torch.bfloat16),
    (1, 2, 77, 77, 8, 8, True, torch.float16),
    (1, 2, 70, 70, 20, 20, True, torch.bfloat16),
    # more (head, query tile) items than SMs, so blocks walk several: every
    # item is computed once, in the kernel's own order, causal and not
    (4, 8, 600, 400, 64, 64, False, torch.bfloat16),
    (4, 8, 600, 400, 64, 64, True, torch.float16),
])
def test_flash_attention_kernel_vs_plain(dev, b, h, sq, skv, dh, dv, causal,
                                         dtype):
    g = torch.Generator().manual_seed(sq + skv + dh + dv)
    q, k, v = (_randn(g, *s, dtype=dtype) for s in
               ((b, h, sq, dh), (b, h, skv, dh), (b, h, skv, dv)))
    want = flash_attention.flash_attention_plain(q, k, v, causal=causal)
    route = f"flash_attention_{flash_attention._attention_route(dtype, dh, dv)}"
    before = flash_attention.launches[route]
    got = ops.flash_attention(q.to(dev), k.to(dev), v.to(dev), causal=causal)
    assert flash_attention.launches[route] == before + 1
    assert got.dtype == dtype and got.shape == (b, h, sq, dv)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=tol,
                               atol=tol)
    if causal and sq > skv:
        assert (got[:, :, : sq - skv] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bf16_at_full_precision(dev, causal):
    """Rows with few keys (the start of a causal window) weigh a handful of
    values: bf16 P would cost several output ulps there. The tensor-core
    route carries P as hi + lo and is held at the smoke's full-width limit
    (atol 1e-3, rtol 1e-2)."""
    g = torch.Generator().manual_seed(5)
    q, k, v = (_randn(g, 1, 4, 640, 128, dtype=torch.bfloat16)
               for _ in range(3))
    want = flash_attention.flash_attention_plain(q, k, v, causal=causal)
    got = ops.flash_attention(q.to(dev), k.to(dev), v.to(dev), causal=causal)
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=1e-2,
                               atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh,dv", [(64, 64), (128, 128), (192, 128)])
def test_flash_decode_kernel_vs_plain(dev, dtype, dh, dv):
    """S = 100 (no tile divides it) with lengths 0, 1, S, past S and one in
    between; a length-0 row is 0."""
    b, h, s = 5, 3, 100
    g = torch.Generator().manual_seed(dh + dv)
    q = _randn(g, b, h, dh, dtype=dtype)
    k = _randn(g, b, s, h, dh, dtype=dtype)
    v = _randn(g, b, s, h, dv, dtype=dtype)
    lens = torch.tensor([0, 1, s, s + 3, 37], dtype=torch.int32)
    want = flash_attention.flash_decode_plain(q, k, v, length=lens)
    before = flash_attention.launches["flash_decode"]
    got = ops.flash_decode(q.to(dev), k.to(dev), v.to(dev), length=lens.to(dev))
    assert flash_attention.launches["flash_decode"] == before + 1
    assert got.dtype == dtype and got.shape == (b, h, dv)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=tol,
                               atol=tol)
    assert (got[0] == 0).all()
    # an int length is every row's; past S it clamps to S
    full = ops.flash_decode(q.to(dev), k.to(dev), v.to(dev), length=s)
    assert torch.equal(full[2:4], got[2:4])


def _decode_inputs(seed, b, h, s, dh, dv, dtype):
    g = torch.Generator().manual_seed(seed)
    return (_randn(g, b, h, dh, dtype=dtype), _randn(g, b, s, h, dh, dtype=dtype),
            _randn(g, b, s, h, dv, dtype=dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("dh,dv", [(64, 64), (128, 128), (192, 128), (24, 40),
                                   (18, 30)])
def test_flash_decode_split_edge_lengths(dev, dtype, dh, dv):
    """Lengths 0, 1, chunk - 1, chunk, chunk + 1, S and past S, with S no
    multiple of the chunk. Rows of 16-byte multiples (24/40 too) take the
    vector path, 18/30 the scalar one."""
    b, h, s = 7, 2, 1000
    c = flash_attention.decode_split(s, b * h)[0]
    q, k, v = _decode_inputs(dh + dv, b, h, s, dh, dv, dtype)
    lens = torch.tensor([0, 1, c - 1, c, c + 1, s, s + 9], dtype=torch.int32)
    want = flash_attention.flash_decode_plain(q, k, v, length=lens)
    before = flash_attention.launches["flash_decode"]
    got = ops.flash_decode(q.to(dev), k.to(dev), v.to(dev), length=lens.to(dev))
    assert flash_attention.launches["flash_decode"] == before + 1
    assert got.dtype == dtype and got.shape == (b, h, dv)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=tol,
                               atol=tol)
    assert (got[0] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,s", [
    (2, 1, 40),      # S below one chunk
    (1, 1, 1000),    # B*H = 1
    (3, 50, 700),    # B*H = 150, past 132 SMs
    (8, 32, 8193),   # 1024-key chunks, S one past a multiple
])
def test_flash_decode_split_grids(dev, b, h, s):
    """Every key valid (an int length, and a CUDA length tensor of S) and
    seeded lengths, against the plain version; one launch per call."""
    q, k, v = _decode_inputs(b + h + s, b, h, s, 64, 64, torch.bfloat16)
    qd, kd, vd = q.to(dev), k.to(dev), v.to(dev)
    tol = ATTN_TOL[torch.bfloat16]
    g = torch.Generator().manual_seed(s)
    seeded = torch.randint(0, s + 1, (b,), generator=g, dtype=torch.int32)
    for length in (s, torch.full((b,), s, dtype=torch.int32), seeded):
        want = flash_attention.flash_decode_plain(q, k, v, length=length)
        dl = length.to(dev) if isinstance(length, torch.Tensor) else length
        before = flash_attention.launches["flash_decode"]
        got = ops.flash_decode(qd, kd, vd, length=dl)
        assert flash_attention.launches["flash_decode"] == before + 1
        torch.testing.assert_close(got.cpu().float(), want.float(), rtol=tol,
                                   atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("d", [18, 40, 1, 10, 64, 129])
@pytest.mark.parametrize("b,l", [(37, 45), (37, 1), (37, 100), (512, 1),
                                 (512, 45), (512, 100), (4096, 1), (4096, 45),
                                 (4096, 100)])
@pytest.mark.parametrize("offset", [0, 1])
def test_embedding_bag_kernel_vs_plain(dev, dtype, mode, d, b, l, offset):
    """Widths from one element to past 32 loads a row (D = 18 is DIN's,
    10 xDeepFM's, 129 f32 loops over five column chunks), batches that
    split a bag over several warps (B = 37, 512) and that do not (4096); a
    table at offset 1 element is a view whose base is not 16-byte aligned,
    so the plan narrows its loads to one element. Bags of length 0 (all
    pads), 1 and L; two calls give the same bits."""
    g = torch.Generator().manual_seed(d + len(mode) + b + l + offset)
    v_rows = 5000
    flat = _randn(g, v_rows * d + offset, dtype=dtype).to(dev)
    table = flat[offset:].view(v_rows, d)
    idx = torch.randint(-1, v_rows, (b, l), generator=g, dtype=torch.int32)
    idx[0] = -1
    idx[1] = -1
    idx[1, l // 2] = 3
    idx[2] = torch.randint(0, v_rows, (l,), generator=g)
    idx = idx.to(dev)
    plan = embedding_bag.table_plan(table, idx)
    if offset:
        assert plan.width == table.element_size()
    want = embedding_bag.embedding_bag_plain(table.cpu(), idx.cpu(),
                                             mode=mode)
    before = embedding_bag.launches["embedding_bag"]
    got = ops.embedding_bag(table, idx, mode=mode)
    assert embedding_bag.launches["embedding_bag"] == before + 1
    assert got.dtype == dtype and got.shape == (b, d)
    tol = BAG_TOL[dtype]
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=tol,
                               atol=tol)
    assert (got[0] == 0).all()
    assert torch.equal(got[1], table[3])
    assert torch.equal(ops.embedding_bag(table, idx, mode=mode), got), plan


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_id_past_the_table_in_any_warp(dev, mode):
    """B = 4 bags of L = 100 share each bag over four warps: an id >= V in
    the first or the last warp's slice makes its whole bag NaN; the other
    bags are as the plain version gives them."""
    g = torch.Generator().manual_seed(4)
    table = _randn(g, 300, 18).to(dev)
    idx = torch.randint(-1, 300, (4, 100), generator=g,
                        dtype=torch.int32).to(dev)
    assert embedding_bag.table_plan(table, idx).warps_per_bag == 4
    want = embedding_bag.embedding_bag_plain(table, idx, mode=mode)
    idx[1, 99] = 300
    idx[2, 0] = 10**6
    got = ops.embedding_bag(table, idx, mode=mode)
    assert torch.isnan(got[1:3]).all()
    torch.testing.assert_close(got[[0, 3]], want[[0, 3]], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.cuda
def test_card_routes_refuse_autograd(dev):
    """``flash_decode`` and ``embedding_bag`` have no backward: each wrapper
    raises on a CUDA input that requires grad while grad is on, before it
    launches, and runs under ``inference_mode`` and ``no_grad``.
    ``flash_attention`` records its backward kernel instead: the output has
    a ``grad_fn``, backward launches ``flash_attention_bwd`` once, and the
    gradients are the plain version's (autograd on the CPU)."""
    g = torch.Generator().manual_seed(7)
    q, k, v = (_randn(g, 1, 2, 40, 64, dtype=torch.bfloat16) for _ in range(3))
    qc, kc, vc = (t.to(dev).requires_grad_() for t in (q, k, v))
    qd = _randn(g, 2, 2, 64).to(dev).requires_grad_()
    kd, vd = (_randn(g, 2, 50, 2, 64).to(dev) for _ in range(2))
    table = _randn(g, 30, 18).to(dev).requires_grad_()
    idx = torch.randint(-1, 30, (4, 6), generator=g,
                        dtype=torch.int32).to(dev)
    calls = [("flash_decode", lambda: ops.flash_decode(qd, kd, vd, length=7)),
             ("embedding_bag", lambda: ops.embedding_bag(table, idx))]
    for name, call in calls:
        before = dict(flash_attention.launches, **embedding_bag.launches)
        with pytest.raises(RuntimeError, match=f"{name}: .*no backward"):
            call()
        assert dict(flash_attention.launches,
                    **embedding_bag.launches) == before
        for mode in (torch.inference_mode, torch.no_grad):
            with mode():
                out = call()
            assert not out.requires_grad and torch.isfinite(out.float()).all()
    cot = _randn(g, 1, 2, 40, 64, dtype=torch.bfloat16)
    out = ops.flash_attention(qc, kc, vc)
    assert out.grad_fn is not None
    before = flash_attention.launches["flash_attention_bwd"]
    out.backward(cot.to(dev))
    assert flash_attention.launches["flash_attention_bwd"] == before + 1
    qh, kh, vh = (t.clone().requires_grad_() for t in (q, k, v))
    ops.flash_attention(qh, kh, vh).backward(cot)
    for got, want in zip((qc.grad, kc.grad, vc.grad), (qh.grad, kh.grad,
                                                       vh.grad)):
        assert got.dtype == torch.bfloat16
        assert (got.cpu().float() - want.float()).abs().max() <= (
            ATTN_TOL[torch.bfloat16] * want.float().abs().max())


# the backward kernel vs its plain version on the same card inputs: within
# tol x the largest |gradient| (f32 sums of up to Skv or Sq products in
# another order; a 16-bit gradient is rounded once on either side)
BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2, torch.float16: 2e-3}


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,sq,skv,dh,dv,causal,dtype,route", [
    (64, 6, 256, 256, 64, 64, True, torch.float32, "tf32"),  # d's layer
    (4, 32, 256, 256, 128, 128, True, torch.bfloat16, "wgmma"),  # D's layer
    (2, 3, 37, 100, 64, 64, False, torch.float32, "tf32"),   # non-causal
    (2, 3, 37, 100, 64, 64, True, torch.bfloat16, "wgmma"),  # Sq < Skv causal
    (2, 2, 100, 37, 64, 64, True, torch.float32, "tf32"),    # Sq > Skv: empty rows
    (1, 2, 70, 70, 48, 32, True, torch.float32, "tf32"),     # dv != dh, padded
    (1, 2, 70, 90, 192, 128, True, torch.bfloat16, "simt"),  # MLA widths, 32-tiles
    (1, 2, 50, 80, 256, 256, False, torch.float16, "simt"),  # widest head
    (2, 2, 65, 65, 128, 128, True, torch.float16, "wgmma"),
    (1, 3, 33, 47, 20, 20, True, torch.bfloat16, "simt"),    # head of 20: scalar loads
    # the new routes' tile edges: Sq, Skv past a tile; Sq > Skv causal
    (1, 2, 130, 75, 128, 128, True, torch.float32, "tf32"),  # 32-row other tiles
    (1, 2, 67, 131, 96, 64, False, torch.float32, "tf32"),   # dh != dv, both padded
    (1, 2, 77, 61, 32, 128, True, torch.float32, "tf32"),    # a wide dv only
    (2, 2, 150, 90, 64, 64, True, torch.bfloat16, "wgmma"),  # Sq > Skv
    (1, 3, 200, 333, 40, 24, True, torch.float16, "wgmma"),  # widths padded to 64
    (1, 2, 129, 129, 128, 64, False, torch.bfloat16, "wgmma"),  # one past a tile
    # shapes the new routes leave to the SIMT kernel
    (1, 2, 45, 61, 20, 12, True, torch.float32, "simt"),     # not multiples of 8
    (1, 2, 40, 40, 160, 64, True, torch.float32, "simt"),    # head above 128
])
def test_attention_backward_kernel_vs_plain(dev, b, h, sq, skv, dh, dv,
                                            causal, dtype, route):
    """Each route against the plain version, with the forward's log-sum-exp
    (as autograd runs it) and without it (the prologue recomputes it);
    counted once under the total and once under its route; bit-equal on a
    second call."""
    assert flash_attention._backward_route(dtype, dh, dv) == route
    g = torch.Generator(device=dev).manual_seed(sq + skv + dh)
    q, k, v = (torch.randn(*s, generator=g, device=dev).to(dtype) for s in
               ((b, h, sq, dh), (b, h, skv, dh), (b, h, skv, dv)))
    dout = torch.randn(b, h, sq, dv, generator=g, device=dev).to(dtype)
    with torch.inference_mode():
        out, lse = flash_attention.flash_attention_lse(q, k, v, causal=causal)
    want = flash_attention.flash_attention_bwd_plain(q, k, v, out, dout,
                                                     causal=causal)
    key = f"flash_attention_bwd_{route}"
    for given in (lse, None):
        before = dict(flash_attention.launches)
        got = flash_attention.flash_attention_bwd(q, k, v, out, dout,
                                                  causal=causal, lse=given)
        torch.cuda.synchronize()
        after = flash_attention.launches
        assert after["flash_attention_bwd"] == before["flash_attention_bwd"] + 1
        assert after[key] == before[key] + 1
        assert sum(after[f"flash_attention_bwd_{r}"] for r in
                   flash_attention.BWD_ROUTES) == sum(
            before[f"flash_attention_bwd_{r}"] for r in
            flash_attention.BWD_ROUTES) + 1
        for x, w in zip(got, want):
            assert x.dtype == dtype and x.shape == w.shape
            assert torch.isfinite(x.float()).all()
            err = (x.float() - w.float()).abs().max()
            assert err <= BWD_TOL[dtype] * w.float().abs().max(), (given is None,
                                                                    err)
        if causal and sq > skv:
            assert (got[0][:, :, : sq - skv] == 0).all()
        again = flash_attention.flash_attention_bwd(q, k, v, out, dout,
                                                    causal=causal, lse=given)
        assert all(torch.equal(x, y) for x, y in zip(got, again))  # no atomics


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,sq,skv,dh,dv,causal,dtype", [
    (2, 6, 256, 256, 64, 64, True, torch.float32),     # SIMT forward
    (1, 4, 256, 256, 128, 128, True, torch.bfloat16),  # wgmma forward
    (1, 2, 100, 37, 64, 48, True, torch.float16),      # empty rows
    (1, 2, 37, 100, 24, 24, False, torch.float32),
    (1, 2, 90, 70, 20, 20, True, torch.bfloat16),      # 16-bit on SIMT
])
def test_forward_lse_kernel_vs_plain(dev, b, h, sq, skv, dh, dv, causal,
                                     dtype):
    """The log-sum-exp the forward writes for the backward against the plain
    version's; the output it returns beside it is the inference forward's,
    bit for bit."""
    g = torch.Generator(device=dev).manual_seed(sq * skv + dh)
    q, k, v = (torch.randn(*s, generator=g, device=dev).to(dtype) for s in
               ((b, h, sq, dh), (b, h, skv, dh), (b, h, skv, dv)))
    with torch.inference_mode():
        out, lse = flash_attention.flash_attention_lse(q, k, v, causal=causal)
        plain = ops.flash_attention(q, k, v, causal=causal)
    _, want = flash_attention.flash_attention_lse_plain(q, k, v,
                                                        causal=causal)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, sq)
    assert torch.equal(out, plain)
    torch.testing.assert_close(lse, want, atol=2e-4, rtol=1e-5)
    if causal and sq > skv:
        assert (lse[:, :, : sq - skv] == flash_attention.NEG_INF).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_blockwise_attention_backward_on_card_equals_cpu(dev, dtype):
    """GQA (32 query heads over 8), S=64: the card's gradients (forward
    kernel, backward kernel, the repeat folded back by autograd) against
    the CPU's (autograd of the plain version)."""
    from repro_torch.models import layers

    g = torch.Generator().manual_seed(3)
    q = torch.randn(2, 64, 32, 128, generator=g).to(dtype)
    k, v = (torch.randn(2, 64, 8, 128, generator=g).to(dtype)
            for _ in range(2))
    cot = torch.randn(2, 64, 32, 128, generator=g)
    grads = {}
    for where in ("cpu", dev):
        ins = [t.detach().clone().to(where).requires_grad_()
               for t in (q, k, v)]
        out = layers.blockwise_attention(*ins, causal=True)
        (out.float() * cot.to(where)).sum().backward()
        grads[str(where)] = [t.grad.cpu().float() for t in ins]
    for got, want in zip(grads[str(dev)], grads["cpu"]):
        err = (got - want).abs().max()
        assert err <= BWD_TOL[dtype] * want.abs().max(), err


@pytest.mark.cuda
def test_train_step_on_card_equals_cpu(dev):
    """One InfoNCE ``Trainer`` step of the smoke tower (f32), micro-batched
    in two, on the card against the same step on the CPU: the loss within
    1e-4 + 1e-3 relative and the parameters within lr/10 on all but 1 % of
    their elements, 2·lr on all (tests/test_torch_train.py's limits); the
    step launches the forward and backward kernels in every layer."""
    from repro_torch.configs.bimetric_paper import cheap_tower_smoke
    from repro_torch.data.pipeline import contrastive_batch_fn
    from repro_torch.models import transformer
    from repro_torch.train import contrastive, optimizer, trainer

    cfg = cheap_tower_smoke()
    model = transformer.init_params(4, cfg, device="cpu")
    batch = contrastive_batch_fn(16, 32, cfg.vocab)(0, 0)
    opt = optimizer.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    tcfg = trainer.TrainerConfig(total_steps=1, grad_accum=2, log_every=100)
    res = {}
    for where in ("cpu", "cuda"):
        flash_attention.reset_launches()
        tr = trainer.Trainer(contrastive.info_nce_loss, model, opt, tcfg,
                             device=where)
        out = tr.run(iter([batch]), log=None)
        res[where] = (out["losses"][0], {
            n: p.detach().cpu() for n, p in tr.params.named_parameters()})
    # two towers (queries, docs) x layers x micro-batches
    assert flash_attention.launches["flash_attention_simt"] == 2 * 2 * cfg.n_layers
    assert flash_attention.launches["flash_attention_bwd"] == 2 * 2 * cfg.n_layers
    np.testing.assert_allclose(res["cuda"][0], res["cpu"][0], rtol=1e-3,
                               atol=1e-4)
    for name, want in res["cpu"][1].items():
        err = (res["cuda"][1][name] - want).abs()
        assert err.max() <= 2 * opt.lr, name
        assert (err > opt.lr / 10).float().mean() <= 1e-2, name


@pytest.mark.cuda
def test_attention_and_bag_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.zeros((1, 2, 8, 16), device=dev)
    strided = x.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(x, strided, x)
    with pytest.raises(ValueError, match="tensors on"):
        ops.flash_attention(x, x.cpu(), x)
    wide = torch.zeros((1, 1, 4, 300), device=dev)
    with pytest.raises(ValueError, match="head dims"):
        ops.flash_attention(wide, wide, wide)
    q = torch.zeros((2, 2, 16), device=dev)
    kv = torch.zeros((2, 5, 2, 16), device=dev)
    with pytest.raises(ValueError, match="tensors on"):
        ops.flash_decode(q, kv.cpu(), kv, length=3)
    with pytest.raises(ValueError, match="length on"):
        ops.flash_decode(q, kv, kv, length=torch.tensor([3, 4]))
    table = torch.zeros((10, 18), device=dev)
    idx = torch.zeros((3, 4), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        ops.embedding_bag(table.t().contiguous().t(), idx)
    with pytest.raises(ValueError, match="tensors on"):
        ops.embedding_bag(table, idx.cpu())
    # an id past the table is a caller error: NaN for its bag, no stray read
    idx[1, 2] = 10
    out = ops.embedding_bag(table, idx)
    assert torch.isnan(out[1]).all() and (out[0] == 0).all()


# --------------------------------------------------------------------------
# the cover-tree slice on the card
# --------------------------------------------------------------------------
def _tree_equal(a, b):
    assert a.scale == b.scale and a.level_scales == b.level_scales
    assert len(a.levels) == len(b.levels)
    for x, y in zip(a.levels, b.levels):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(a.children, b.children):
        np.testing.assert_array_equal(x.parents, y.parents)
        np.testing.assert_array_equal(x.indptr, y.indptr)
        np.testing.assert_array_equal(x.kids, y.kids)


@pytest.mark.cuda
def test_cover_tree_build_on_card_equals_cpu(dev):
    """N=2048 clustered rows at the cheap tower's width: the card's build
    (f64 products on the card, direct form in NumPy's order) is the CPU's."""
    rng = np.random.default_rng(9)
    centers = rng.normal(size=(32, 384)) * 4.0
    x = (centers[rng.integers(0, 32, 2048)]
         + rng.normal(size=(2048, 384))).astype(np.float32)
    on_card = covertree.build(torch.from_numpy(x).to(dev), T=3.0, device=dev)
    on_cpu = covertree.build(x, T=3.0, device="cpu")
    _tree_equal(on_card, on_cpu)
    assert torch.equal(covertree.flatten(on_card, device=dev).children.cpu(),
                       covertree.flatten(on_cpu, device="cpu").children)


@pytest.mark.cuda
def test_cover_tree_search_on_card_equals_cpu(dev):
    """The JAX cover-tree tests' inputs (n=300, dim 12, T=2): the descent
    launches the kernels and gives the CPU's ids and D-call counts."""
    rng = np.random.default_rng(3)
    corpus = rng.normal(size=(300, 12)).astype(np.float32)
    proj = rng.normal(size=(12, 5)) / np.sqrt(5)
    x_d = (corpus @ proj).astype(np.float64)
    queries = rng.normal(size=(8, 12)).astype(np.float32)
    tree = covertree.build(x_d, T=2.0, device="cpu")
    flat_cpu = covertree.flatten(tree, device="cpu")
    flat = covertree.flatten(tree, device=dev)
    for backend_ in ("ref", "matmul"):
        for eps, quota in ((1.0, None), (0.5, None), (0.25, None),
                           (0.5, 7), (0.5, 120)):
            l2_topk.reset_launches()
            got = covertree.search_corpus(flat, corpus, queries, eps=eps,
                                          k=10, quota=quota, backend=backend_,
                                          device=dev)
            assert l2_topk.launches["gather_score"] > 0
            assert l2_topk.launches["beam_merge_topk"] > 0
            want = covertree.search_corpus(flat_cpu, corpus, queries,
                                           eps=eps, k=10, quota=quota,
                                           backend=backend_, device="cpu")
            assert torch.equal(got.ids.cpu(), want.ids)
            assert torch.equal(got.n_calls.cpu(), want.n_calls)
            torch.testing.assert_close(got.dists.cpu(), want.dists,
                                       rtol=1e-5, atol=1e-5)


def _tower_on_both(cfg):
    """A tower drawn on the card and its copy on the CPU."""
    from repro_torch.models import transformer

    card = transformer.init_params(11, cfg, device="cuda")
    host = transformer.Transformer(cfg, device="cpu")
    host.load_state_dict(card.state_dict())
    return card, host


TOWER_CFGS = {
    # bf16 GQA, 8 query heads over 2 kv heads, qk-norm: the tensor-core route
    "gqa_bf16": dict(name="gqa-bf16", n_layers=2, d_model=256, n_heads=8,
                     n_kv_heads=2, head_dim=32, d_ff=512, vocab=1000,
                     qk_norm=True, dtype=torch.bfloat16, embed_dim=128,
                     rope_theta=1e6),
    # f32, the cheap tower's smoke width: the SIMT route
    "f32": dict(name="f32", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                head_dim=16, d_ff=128, vocab=512, embed_dim=32),
}


@pytest.mark.cuda
@pytest.mark.parametrize("which", list(TOWER_CFGS))
def test_tower_on_card_equals_cpu(dev, which):
    """The tower on the card against its copy on the CPU (whose attention is
    the plain version), at phase 8's limits: f32 max |d| <= 1e-4; bf16
    cosine >= 0.999 per row and max |d| <= 2e-2. Each layer's attention
    launches its route's kernel once; an id out of range (-1, V, V+3,
    -V-5) neither asserts on the card nor differs from the CPU."""
    from repro_torch.models import transformer
    from repro_torch.serve.engine import EmbedTower

    cfg = transformer.TransformerConfig(**TOWER_CFGS[which])
    card, host = _tower_on_both(cfg)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab, (5, 70), dtype=np.int32)
    toks[1, :4] = [-1, cfg.vocab, cfg.vocab + 3, -cfg.vocab - 5]
    route = ("flash_attention_wgmma" if cfg.dtype == torch.bfloat16
             else "flash_attention_simt")
    flash_attention.reset_launches()
    got = EmbedTower(card).embed(toks, batch=4)
    torch.cuda.synchronize()
    assert flash_attention.launches[route] == cfg.n_layers * 2
    assert sum(flash_attention.launches.values()) == cfg.n_layers * 2
    want = EmbedTower(host, device="cpu").embed(toks, batch=4)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    err = np.abs(got - want).max()
    if cfg.dtype == torch.bfloat16:
        assert err <= 2e-2 and (np.sum(got * want, axis=1) >= 0.999).all()
    else:
        assert err <= 1e-4
    assert np.array_equal(EmbedTower(card).embed(toks, batch=4), got)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [200, 32])
@torch.inference_mode()  # serving's mode: no autograd recording
def test_blockwise_attention_on_card_is_the_kernel(dev, s):
    """GQA attention at a D-tower layer's head shape (32 over 8 heads, dh
    128, bf16; S of a doc-like length and of a query's 32 tokens) through
    the wgmma route, within the full-width limit of the plain version on
    the repeated heads."""
    from repro_torch.models import layers

    g = torch.Generator(device=dev).manual_seed(2)
    q = torch.randn(2, s, 32, 128, generator=g, device=dev).bfloat16()
    k, v = (torch.randn(2, s, 8, 128, generator=g, device=dev).bfloat16()
            for _ in range(2))
    before = flash_attention.launches["flash_attention_wgmma"]
    got = layers.blockwise_attention(q, k, v, causal=True)
    assert flash_attention.launches["flash_attention_wgmma"] == before + 1
    want = flash_attention.flash_attention_plain(
        *(layers.repeat_kv(t, r).transpose(1, 2).contiguous()
          for t, r in ((q, 1), (k, 4), (v, 4)))).transpose(1, 2)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                               atol=1e-3)
    with pytest.raises(ValueError, match="q_offset"):
        layers.blockwise_attention(q, k, v, causal=True, q_offset=1)


@pytest.mark.cuda
@pytest.mark.parametrize("index", ["vamana", "covertree"])
def test_serve_sync_equals_async_on_card(dev, index):
    """The serving engine on the card at the launcher's smoke towers: the
    async slot drive (3 slots, mixed requests, from an empty doc cache)
    answers bit for bit what the sync drive answers, and both launch the
    search kernels."""
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import transformer
    from repro_torch.serve import BiMetricEngine, EmbedTower, SearchRequest

    cheap = EmbedTower(transformer.init_params(
        0, launch_serve.cheap_smoke(), device=dev))
    expensive = EmbedTower(transformer.init_params(
        1, launch_serve.expensive_smoke(), device=dev))
    rng = np.random.default_rng(6)
    corpus = rng.integers(0, 512, (256, 16), dtype=np.int32)
    eng = BiMetricEngine(cheap, expensive, corpus, slots=3, index=index)
    reqs = [SearchRequest(tokens=corpus[r], quota=q, k=k, **kw)
            for r, q, k, kw in ((3, 24, 10, {}), (40, 8, 5, {}),
                                (77, 16, 10, dict(n_seeds=4)),
                                (12, 24, 10, dict(expand_width=2)),
                                (55, 0, 5, {}), (9, 12, 3, {}),
                                (61, 24, 10, dict(priority=2)))]
    l2_topk.reset_launches()
    ref = eng.query_batch(reqs)
    assert l2_topk.launches["gather_score"] > 0
    assert l2_topk.launches["beam_merge_topk"] > 0
    eng.reset_doc_cache()
    futs = [eng.submit(r) for r in reqs]
    for r, f, want in zip(reqs, futs, ref):
        got = f.result(timeout=120)
        assert np.array_equal(got.ids, want.ids)
        assert np.array_equal(got.dists, want.dists)
        assert (got.stats.D_calls, got.stats.d_calls) == (
            want.stats.D_calls, want.stats.d_calls)
        assert got.stats.D_calls <= r.quota and not got.stats.degraded
    eng.close(timeout=60)


@pytest.mark.cuda
@pytest.mark.parametrize("index", ["vamana", "covertree"])
def test_sharded_serve_equals_unsharded_on_card(dev, index):
    """The engine at shards=2 on ``["cuda:0"] * 2`` (smoke towers, an
    uneven corpus): the sync and the async drive answer bit for bit what
    the shards=1 sync drive answers. The vamana engine's stage 1 launches
    the shard-local gather twice a wave."""
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import transformer
    from repro_torch.serve import BiMetricEngine, EmbedTower, SearchRequest

    cheap = EmbedTower(transformer.init_params(
        0, launch_serve.cheap_smoke(), device=dev))
    expensive = EmbedTower(transformer.init_params(
        1, launch_serve.expensive_smoke(), device=dev))
    corpus = np.random.default_rng(7).integers(0, 512, (257, 16),
                                               dtype=np.int32)
    reqs = [SearchRequest(tokens=corpus[r], quota=q, k=k)
            for r, q, k in ((3, 24, 10), (40, 8, 5), (77, 16, 10),
                            (55, 0, 5), (9, 12, 3))]
    ref = BiMetricEngine(cheap, expensive, corpus, index=index).query_batch(
        reqs)
    one = torch.device("cuda", 0)
    eng = BiMetricEngine(cheap, expensive, corpus, index=index, shards=2,
                         slots=2, mesh=sharding.search_mesh(2, [one] * 2))
    l2_topk.reset_launches()
    sync = eng.query_batch(reqs)
    local = l2_topk.launches["gather_score_local"]
    assert (local > 0) == (index == "vamana") and local % 2 == 0
    eng.reset_doc_cache()
    futs = [eng.submit(r) for r in reqs]
    for got_s, f, want in zip(sync, futs, ref):
        got_a = f.result(timeout=120)
        for got in (got_s, got_a):
            assert np.array_equal(got.ids, want.ids)
            assert np.array_equal(got.dists, want.dists)
            assert (got.stats.D_calls, got.stats.d_calls) == (
                want.stats.D_calls, want.stats.d_calls)
    eng.close(timeout=60)


@pytest.mark.cuda
def test_scatter_gather_search_on_card_equals_cpu(dev):
    """``core/distributed.py`` at S=2 on ``["cuda:0"] * 2`` against the
    same two graphs searched with ``device="cpu"`` (tests/test_distributed.
    py's data shapes, n=512): ids and D calls equal, dists within 1e-5; the
    card's path launches ``gather_score`` and the merge, never the
    shard-local gather; shard rows are views of the corpus on the card."""
    from repro_torch import convert
    from repro_torch.core import distributed
    from repro_torch.core.vamana import VamanaConfig

    rng = np.random.default_rng(12)
    cD = rng.normal(size=(512, 48)).astype(np.float32)
    cd = (cD[:, :8] + 0.1 * rng.normal(size=(512, 8))).astype(np.float32)
    qD = (cD[:16] + 0.3 * rng.normal(size=(16, 48))).astype(np.float32)
    qd = qD[:, :8].copy()
    cfg = VamanaConfig(max_degree=12, l_build=16, pool_size=32,
                       rev_candidates=12, build_batch=256)
    one = torch.device("cuda", 0)
    mesh = sharding.search_mesh(2, devices=[one] * 2)
    corpus_d, corpus_D = torch.from_numpy(cd).to(one), torch.from_numpy(
        cD).to(one)
    idx = distributed.build_sharded(corpus_d, corpus_D, 2, cfg, mesh=mesh)
    assert idx.emb_cheap[1].data_ptr() == corpus_d[256:].data_ptr()
    stacked = lambda ts: np.stack([t.cpu().numpy() for t in ts])
    host = convert.sharded_index_from_numpy(
        stacked(idx.adjacency), np.array(idx.medoid), stacked(idx.emb_cheap),
        stacked(idx.emb_expensive), cfg, device="cpu")
    cpu_mesh = sharding.search_mesh(2, devices=["cpu"] * 2)
    for quota in (10, 64):
        l2_topk.reset_launches()
        got = distributed.sharded_bimetric_search(
            mesh, idx, qd, qD, quota=quota, k=10)
        torch.cuda.synchronize()
        assert l2_topk.launches["gather_score"] > 0
        assert l2_topk.launches["beam_merge_topk"] > 0
        assert l2_topk.launches["gather_score_local"] == 0
        want = distributed.sharded_bimetric_search(
            cpu_mesh, host, qd, qD, quota=quota, k=10)
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[2].cpu(), want[2])
        torch.testing.assert_close(got[1].cpu(), want[1], rtol=1e-5,
                                   atol=1e-5)
        assert int(got[2].max()) <= 2 * max(10, quota // 2)
