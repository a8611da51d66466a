"""Port batched engine vs the JAX reference engine.

The grid of the JAX package's own batched-engine tests: quota
{0, 1, 3, 11, 40, NO_QUOTA} × uneven N {130, 97} × expand width {1, 2} on
random graphs, with both dedup backends of the port held against the JAX
bitmap run, plus mixed (B,) quotas. Pool ids, ``n_calls``, ``n_steps`` and
the scored bitmap are exact; distances agree within 1e-5 (torch and XLA sum
the 8-wide rows in different orders). Within the port, a batched search at
E=1 is bit-exact against running each query alone.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import beam as jbeam
from repro.core import distances as jdist
from repro_torch.core import beam as tbeam
from repro_torch.core import distances as tdist

QUOTAS = [0, 1, 3, 11, 40, "none"]


def _random_graph(seed, n, r=6, dim=8, b=5):
    rng = np.random.default_rng(seed)
    adj = rng.integers(0, n, (n, r)).astype(np.int32)
    adj[rng.random((n, r)) < 0.2] = -1  # ragged out-degrees
    emb = rng.normal(size=(n, dim)).astype(np.float32)
    qs = rng.normal(size=(b, dim)).astype(np.float32)
    return adj, emb, qs


def _jax_search(adj, emb, qs, entries, **kw):
    em = jdist.EmbeddingMetric(jnp.asarray(emb))
    res = jbeam.batched_greedy_search(
        em.dists_batch, jnp.asarray(adj), jnp.asarray(qs),
        jnp.asarray(entries), **kw)
    return [np.asarray(a) for a in res]


def _torch_search(adj, emb, qs, entries, **kw):
    em = tdist.EmbeddingMetric(torch.from_numpy(emb))
    res = tbeam.batched_greedy_search(
        em.dists_batch, torch.from_numpy(adj), torch.from_numpy(qs),
        torch.from_numpy(np.array(entries)), **kw)
    return [a.numpy() for a in res]


def _assert_same(j, t, ctx):
    ids_j, d_j, sc_j, calls_j, steps_j = j
    ids_t, d_t, sc_t, calls_t, steps_t = t
    np.testing.assert_array_equal(ids_t, ids_j, err_msg=f"pool_ids {ctx}")
    np.testing.assert_allclose(d_t, d_j, rtol=1e-5, atol=1e-5,
                               err_msg=f"pool_dists {ctx}")
    np.testing.assert_array_equal(sc_t, sc_j, err_msg=f"scored {ctx}")
    np.testing.assert_array_equal(calls_t, calls_j, err_msg=f"n_calls {ctx}")
    np.testing.assert_array_equal(steps_t, steps_j, err_msg=f"n_steps {ctx}")


@pytest.mark.parametrize("expand_width", [1, 2])
@pytest.mark.parametrize("n", [130, 97])
@pytest.mark.parametrize("quota", QUOTAS)
def test_engine_matches_jax(quota, n, expand_width):
    q = tbeam.NO_QUOTA if quota == "none" else quota
    assert tbeam.NO_QUOTA == int(jbeam.NO_QUOTA)
    adj, emb, qs = _random_graph(seed=n + (q % 97), n=n)
    entries = np.broadcast_to(np.array([0, n // 2, n - 1], np.int32), (5, 3))
    kw = dict(n_points=n, beam_width=8, pool_size=16, quota=q,
              expand_width=expand_width, max_steps=200)
    want = _jax_search(adj, emb, qs, entries, dedup="bitmap", **kw)
    for dedup in ("bitmap", "sorted"):
        if dedup == "sorted" and q == tbeam.NO_QUOTA:
            continue  # an unbounded quota has no finite set capacity
        got = _torch_search(adj, emb, qs, entries, dedup=dedup, **kw)
        _assert_same(want, got, (quota, n, expand_width, dedup))
    assert (want[3] <= q).all()


def test_mixed_quota_waves_match_jax():
    """A (B,) quota vector (a quota-0 row included) freezes each row at its
    own budget, in both dedup backends."""
    n = 97
    adj, emb, qs = _random_graph(seed=5, n=n, b=4)
    entries = np.zeros((4, 1), np.int32)
    quotas = np.array([0, 7, 23, 40], np.int32)
    kw = dict(n_points=n, beam_width=6, max_steps=300)
    want = _jax_search(adj, emb, qs, entries, quota=jnp.asarray(quotas),
                       dedup="bitmap", **kw)
    for dedup in ("bitmap", "sorted"):
        got = _torch_search(adj, emb, qs, entries,
                            quota=torch.from_numpy(quotas), dedup=dedup, **kw)
        _assert_same(want, got, dedup)
    assert (want[3] <= quotas).all()


@pytest.mark.parametrize("quota", [11, "none"])
def test_batch_matches_single_query(quota):
    """At E=1 each row of a batched search equals that query run alone."""
    q = tbeam.NO_QUOTA if quota == "none" else quota
    n = 130
    adj, emb, qs = _random_graph(seed=21, n=n)
    entries = np.broadcast_to(np.array([0, 64, 100], np.int32), (5, 3))
    kw = dict(n_points=n, beam_width=8, pool_size=16, quota=q, max_steps=100)
    batched = _torch_search(adj, emb, qs, entries, **kw)
    for b in range(5):
        single = _torch_search(adj, emb, qs[b:b + 1], entries[b:b + 1], **kw)
        for name, x, y in zip(tbeam.SearchResult._fields, batched, single):
            assert np.array_equal(x[b], y[0]), (name, b)


def test_dedup_resolution_and_zero_capacity():
    assert tbeam.resolve_dedup("auto", None, 17, 128, drive="fused") == (
        "bitmap", None)
    assert tbeam.resolve_dedup("auto", None, 17, 128) == ("sorted", 17)
    assert tbeam.resolve_dedup("auto", None, torch.tensor([3, 9, 17]),
                               128) == ("sorted", 17)
    assert tbeam.resolve_dedup("auto", None, tbeam.NO_QUOTA, 128) == (
        "bitmap", None)
    with pytest.raises(ValueError):
        tbeam.resolve_dedup("sorted", 8, 17, 128)
    empty = tbeam.empty_scored_set(2, 0)
    assert tbeam.scored_set_to_bitmap(empty, 16).sum() == 0
    state, safe, keep = tbeam.init_state(
        torch.zeros((3, 1), dtype=torch.int32), n_points=64, pool_size=8,
        quota=torch.tensor([0, 7, 23]), dedup="sorted", set_capacity=23)
    assert torch.equal(state.scored.count, state.n_calls)
    assert state.n_calls.tolist() == [0, 1, 1]


def test_bitmap_scatter_or_ignores_padding_lanes():
    """Padding lanes alias column 0 with mark=False: the scatter is an OR,
    so a real mark on column 0 in the same wave survives."""
    bitmap = torch.zeros((1, 8), dtype=torch.bool)
    ids = torch.tensor([[-1, 0, -1, 3]], dtype=torch.int32)
    mark = torch.tensor([[False, True, False, True]])
    out = tbeam._scored_scatter(bitmap, ids, mark)
    assert out.tolist() == [[True, False, False, True] + [False] * 4]


def _sorted_by_kernel_key(d):
    """Non-decreasing in the merge kernel's key order: -0.0 and +0.0 equal,
    NaN after +inf."""
    a, b = d[:, :-1], d[:, 1:]
    return bool((torch.isnan(b) | (~torch.isnan(a) & (a <= b))).all())


def _spy_commits(monkeypatch):
    pools = []
    commit = tbeam.commit_scores

    def spy(state, safe, keep, dists):
        out = commit(state, safe, keep, dists)
        pools.append(out.pool_dists.clone())
        return out

    monkeypatch.setattr(tbeam, "commit_scores", spy)
    return pools


@pytest.mark.parametrize("expand_width", [1, 2])
@pytest.mark.parametrize("dedup", ["bitmap", "sorted"])
def test_every_committed_pool_is_sorted(monkeypatch, dedup, expand_width):
    """The fast path of the merge kernel takes a pool whose keys are
    non-decreasing: every pool the engine commits is, from the all-+inf
    start on, for both dedup backends."""
    pools = _spy_commits(monkeypatch)
    n = 130
    adj, emb, qs = _random_graph(seed=3, n=n)
    entries = np.broadcast_to(np.array([0, n // 2, n - 1], np.int32), (5, 3))
    _torch_search(adj, emb, qs, entries, n_points=n, beam_width=8,
                  pool_size=16, quota=40, expand_width=expand_width,
                  max_steps=200, dedup=dedup)
    assert len(pools) > 2
    assert all(_sorted_by_kernel_key(p) for p in pools)


def test_every_committed_pool_is_sorted_sharded(monkeypatch):
    """The same at shards=2 (pools replicated, the merge on the first
    device)."""
    from repro_torch.distributed import sharding

    pools = _spy_commits(monkeypatch)
    n = 97
    adj, emb, qs = _random_graph(seed=4, n=n)
    entries = np.zeros((5, 2), np.int32)
    entries[:, 1] = n - 1
    for dedup in ("bitmap", "sorted"):
        tbeam.sharded_greedy_search(
            torch.from_numpy(emb), torch.from_numpy(adj), torch.from_numpy(qs),
            torch.from_numpy(entries), shards=2, metric="l2",
            mesh=sharding.search_mesh(2, devices=["cpu"] * 2), beam_width=6,
            pool_size=12, quota=30, dedup=dedup, device="cpu")
    assert len(pools) > 4
    assert all(_sorted_by_kernel_key(p) for p in pools)

