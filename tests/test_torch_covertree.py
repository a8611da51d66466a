"""The port's cover tree vs the JAX package's, on the CPU.

The inputs of the JAX cover-tree tests (``tests/test_covertree.py``: n=300,
dim 12, T=2.0, eight queries; its ``data`` fixture at T=1.0) and one n=4,200
proxy, past the 4,096-row closest-pair sample. The port's ``build`` must
give the JAX build's tree (levels, scale, level scales, children as sets)
at any block width and however wide the direct form's band is; ``flatten``
the same arrays. The descent (``search_corpus``, ``bimetric_search`` with a
``FlatCoverTree``) must give JAX's ids and D-call counts, equal to the NumPy
oracle's, at every ε of the grid and for both backends; at binding quotas
the counts equal the oracle's. At ``shards`` in {2, 4} (``["cpu"] * S``
meshes) the descent equals the unsharded one bit for bit, as
``tests/test_covertree.py::test_sharded_parity`` holds JAX's. The engine
pieces of the slice
(``frontier_count``, ``reset_expanded``, ``plan_step(level=)``) are held
against JAX on seeded inputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import beam as jbeam
from repro.core import covertree as jct
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.core import beam as tbeam
from repro_torch.core import bimetric as tbm
from repro_torch.core import covertree as tct
from repro_torch.distributed import sharding as tsharding
from repro_torch.kernels import ops as tops

CPU = "cpu"
GRID_EPS = (1.0, 0.5, 0.25)


def _flat_parts_inputs():
    """``tests/test_covertree.py::flat_parts``: D rows, the proxy, queries."""
    rng = np.random.default_rng(3)
    n, dim = 300, 12
    corpus = rng.normal(size=(n, dim)).astype(np.float32)
    proj = rng.normal(size=(dim, 5)) / np.sqrt(5)
    x_d = (corpus @ proj).astype(np.float64)
    queries = rng.normal(size=(8, dim)).astype(np.float32)
    return corpus, x_d, queries


def _data_proxy():
    """``tests/test_covertree.py::data``'s proxy (n=400)."""
    rng = np.random.default_rng(0)
    x_D = rng.normal(size=(400, 12))
    proj = rng.normal(size=(12, 5)) / np.sqrt(5)
    return x_D @ proj


BUILDS = {  # name -> (x, T)
    "flat_parts": (_flat_parts_inputs()[1], 2.0),
    "data": (_data_proxy(), 1.0),
    "n4200": (np.random.default_rng(5).normal(size=(4200, 5)), 2.0),
}


@pytest.fixture(scope="module")
def jax_trees():
    """The JAX builds, once per module (n=4,200 takes seconds)."""
    return {name: jct.build(x, T=t) for name, (x, t) in BUILDS.items()}


@pytest.fixture(scope="module")
def parts(jax_trees):
    corpus, _, queries = _flat_parts_inputs()
    tree = jax_trees["flat_parts"]
    flat = jct.flatten(tree)
    return tree, flat, convert.flat_cover_tree_from_numpy(*flat,
                                                          device=CPU), \
        corpus, queries


@pytest.fixture(scope="module")
def jax_search(parts):
    """JAX's descent on ``parts`` by ε: its unfused drive with one scoring
    closure, so the level programs compile once."""
    _, flat, _, corpus, queries = parts
    fn = jbeam.fused_dist_fn(jnp.asarray(corpus), "l2")
    memo = {}

    def run(eps):
        if eps not in memo:
            memo[eps] = jct.search_batched(flat, fn, jnp.asarray(queries),
                                           eps=eps, k=10, fuse_levels=False)
        return memo[eps]
    return run


def _assert_same_tree(want, got):
    assert got.scale == want.scale
    assert got.level_scales == want.level_scales
    assert got.T == want.T and got.n == want.n
    assert [len(a) for a in got.levels] == [len(a) for a in want.levels]
    for a, b in zip(want.levels, got.levels):
        np.testing.assert_array_equal(b, a)
    assert len(got.children) == len(want.children)
    for j, (a, b) in enumerate(zip(want.children, got.children)):
        assert set(b) == set(a), j
        for p in a:
            assert set(np.asarray(b[p]).tolist()) == set(
                np.asarray(a[p]).tolist()), (j, p)


@pytest.mark.parametrize("name", list(BUILDS))
def test_build_matches_jax(jax_trees, name):
    x, t = BUILDS[name]
    _assert_same_tree(jax_trees[name], tct.build(x, T=t, device=CPU))


@pytest.mark.parametrize("width", [1, 7, 64])
@pytest.mark.parametrize("name", ["flat_parts", "data"])
def test_block_greedy_equals_sequential_greedy(jax_trees, monkeypatch, name,
                                               width):
    """Width 1 is the plain sequential greedy; every width gives its tree."""
    monkeypatch.setattr(tct, "_BLOCK", width)
    x, t = BUILDS[name]
    _assert_same_tree(jax_trees[name], tct.build(x, T=t, device=CPU))


def test_direct_form_decides_the_band(jax_trees, monkeypatch):
    """With a band so wide that the product form settles few pairs, the
    direct form decides most tests and the tree is the same."""
    monkeypatch.setattr(tct, "_MARGIN", 0.05)
    x, t = BUILDS["data"]
    _assert_same_tree(jax_trees["data"], tct.build(x, T=t, device=CPU))


def test_build_seed_and_max_levels_match_jax():
    x, t = BUILDS["flat_parts"]
    for kw in (dict(seed=7), dict(max_levels=3)):
        _assert_same_tree(jct.build(x, T=t, **kw),
                          tct.build(x, T=t, device=CPU, **kw))


@pytest.mark.parametrize("width", [1, 5, 8, 12, 100, 129, 384])
def test_np_sum_is_numpy_bit_for_bit(width):
    rng = np.random.default_rng(width)
    a, b = rng.normal(size=(2, 50, width)) * rng.lognormal(size=(2, 50, 1))
    want = ((a - b) ** 2).sum(-1)
    got = tct._direct(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", list(BUILDS))
def test_flatten_matches_jax(jax_trees, name):
    x, t = BUILDS[name]
    want = jct.flatten(jax_trees[name])
    got = tct.flatten(tct.build(x, T=t, device=CPU), device=CPU)
    np.testing.assert_array_equal(got.children.numpy(), want.children)
    assert got.children.dtype == torch.int32
    np.testing.assert_array_equal(got.radii, want.radii)
    np.testing.assert_array_equal(got.root_ids, want.root_ids)
    assert got.root_ids.dtype == want.root_ids.dtype
    assert (got.scale, got.T, got.n, got.depth, got.fanout) == (
        want.scale, want.T, want.n, want.depth, want.fanout)


def _oracle_fn(corpus, q):
    def D(ids):
        d = corpus[ids].astype(np.float64) - np.asarray(q, np.float64)
        return np.sqrt((d * d).sum(-1))
    return D


@pytest.mark.parametrize("quota", [None, 40])
def test_search_oracle_matches_jax(parts, quota):
    tree, _, _, corpus, queries = parts
    x, t = BUILDS["flat_parts"]
    port_tree = tct.build(x, T=t, device=CPU)
    for eps in GRID_EPS:
        for q in queries:
            want = jct.search(tree, _oracle_fn(corpus, q), eps=eps, k=10,
                              quota=quota)
            got = tct.search(port_tree, _oracle_fn(corpus, q), eps=eps,
                             k=10, quota=quota)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
            assert got[2] == want[2]


@pytest.mark.parametrize("backend", ["ref", "matmul"])
@pytest.mark.parametrize("eps", GRID_EPS)
def test_search_corpus_matches_jax_and_oracle(parts, jax_search, eps,
                                              backend):
    tree, flat, tflat, corpus, queries = parts
    want = jax_search(eps)
    got = tct.search_corpus(tflat, torch.from_numpy(corpus),
                            torch.from_numpy(queries), eps=eps, k=10,
                            backend=backend, device=CPU)
    ids, calls = got.ids.numpy(), got.n_calls.numpy()
    np.testing.assert_array_equal(ids, np.asarray(want.ids))
    np.testing.assert_array_equal(calls, np.asarray(want.n_calls))
    np.testing.assert_allclose(got.dists.numpy(), np.asarray(want.dists),
                               rtol=1e-5)
    for i, q in enumerate(queries):
        oids, _, ocalls = jct.search(tree, _oracle_fn(corpus, q), eps=eps,
                                     k=10)
        row = ids[i][ids[i] >= 0]
        assert list(row) == list(oids[:len(row)]), (eps, i)
        assert calls[i] == ocalls, (eps, i)


@pytest.mark.parametrize("quota", [1, 7, 40, 120])
def test_quota_call_counts_match_oracle(parts, quota):
    tree, flat, tflat, corpus, queries = parts
    got = tct.search_corpus(tflat, corpus, queries, eps=0.5, k=10,
                            quota=quota, device=CPU)
    calls = got.n_calls.numpy()
    assert (calls <= quota).all()
    for i, q in enumerate(queries):
        _, _, ocalls = jct.search(tree, _oracle_fn(corpus, q), eps=0.5, k=10,
                                  quota=quota)
        assert calls[i] == ocalls, (quota, i)


def test_search_on_the_ports_own_flatten(parts):
    """The port's build and flatten feed the descent: the same result."""
    _, _, tflat, corpus, queries = parts
    x, t = BUILDS["flat_parts"]
    own = tct.flatten(tct.build(x, T=t, device=CPU), device=CPU)
    a = tct.search_corpus(own, corpus, queries, k=10, quota=60, device=CPU)
    b = tct.search_corpus(tflat, corpus, queries, k=10, quota=60, device=CPU)
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_fuse_levels_and_mixed_quota(parts):
    """``fuse_levels`` changes nothing; a (B,) quota equals each row run at
    its own budget."""
    _, _, tflat, corpus, queries = parts
    fn = tbeam.fused_dist_fn(torch.from_numpy(corpus), "l2")
    qs = torch.from_numpy(queries)
    base = tct.search_batched(tflat, fn, qs, k=10, quota=50, device=CPU)
    for fuse in (True, False):
        res = tct.search_batched(tflat, fn, qs, k=10, quota=50,
                                 fuse_levels=fuse, device=CPU)
        for f in base._fields:
            assert torch.equal(getattr(res, f), getattr(base, f)), (fuse, f)
    quotas = np.array([1, 5, 50, 120, 300, 7, 0, 60], np.int32)
    mixed = tct.search_batched(tflat, fn, qs, k=10,
                               quota=torch.from_numpy(quotas),
                               pool_size=300, device=CPU)
    for i, q in enumerate(quotas):
        one = tct.search_batched(tflat, fn, qs[i:i + 1], k=10, quota=int(q),
                                 pool_size=300, device=CPU)
        assert torch.equal(mixed.ids[i], one.ids[0]), i
        assert int(mixed.n_calls[i]) == int(one.n_calls[0]) <= q, i


def test_bimetric_search_covertree_dispatch(parts):
    """The corpora and callable forms agree, d_calls are 0, and at an
    unbinding quota the ids and counts are the oracle's (and JAX's)."""
    tree, flat, tflat, corpus, queries = parts
    c = torch.from_numpy(corpus)
    qs = torch.from_numpy(queries)

    def exp_batch(q_ctx, ids):
        d = c[ids.clamp(min=0).long()] - q_ctx[:, None, :]
        out = torch.sqrt((d * d).sum(-1))
        return torch.where(ids >= 0, out, torch.full_like(out, float("inf")))

    res_c = tbm.bimetric_search(None, None, tflat, None, qs, n_points=tflat.n,
                                quota=120, k=10, corpora=(c, c), eps=0.5,
                                device=CPU)
    res_f = tbm.bimetric_search(None, exp_batch, tflat, None, qs,
                                n_points=tflat.n, quota=120, k=10, eps=0.5,
                                device=CPU)
    assert torch.equal(res_c.ids, res_f.ids)
    assert torch.equal(res_c.D_calls, res_f.D_calls)
    assert (res_c.d_calls == 0).all() and (res_f.d_calls == 0).all()
    full = tbm.bimetric_search(None, None, tflat, None, qs, n_points=tflat.n,
                               quota=tflat.n, k=10, corpora=(c, c), eps=0.5,
                               device=CPU)
    ids, calls = full.ids.numpy(), full.D_calls.numpy()
    for i, q in enumerate(queries):
        oids, _, ocalls = tct.search(tree, _oracle_fn(corpus, q), eps=0.5,
                                     k=10)
        row = ids[i][ids[i] >= 0]
        assert list(row) == list(oids[:len(row)]), i
        assert calls[i] == ocalls, i


@pytest.mark.parametrize("eps", GRID_EPS)
def test_sharded_parity(parts, eps):
    """``tests/test_covertree.py::test_sharded_parity`` at S in {2, 4}: the
    descent stepped on a ``["cpu"] * S`` mesh (``search_corpus(shards=)``,
    ``search_batched(stepper=)`` and ``bimetric_search`` with a
    ``FlatCoverTree``) equals the unsharded host drive bit for bit, dists
    included."""
    _, _, tflat, corpus, queries = parts
    c, qs = torch.from_numpy(corpus), torch.from_numpy(queries)
    fn = tbeam.fused_dist_fn(c, "l2")
    ref = tct.search_batched(tflat, fn, qs, eps=eps, k=10, quota=120,
                             device=CPU)
    for s in (2, 4):
        mesh = tsharding.search_mesh(s, devices=[CPU] * s)
        stepper = tbeam.ShardedStepper(shards=s, n_points=tflat.n, mesh=mesh,
                                       device=CPU)
        runs = [
            tct.search_corpus(tflat, corpus, queries, eps=eps, k=10,
                              quota=120, shards=s, mesh=mesh, device=CPU),
            tct.search_batched(tflat, fn, qs, eps=eps, k=10, quota=120,
                               stepper=stepper, device=CPU),
            tct.search_batched(tflat, fn, qs, eps=eps, k=10, quota=120,
                               dedup="bitmap", stepper=stepper, device=CPU)]
        bm = tbm.bimetric_search(None, None, tflat, None, qs,
                                 n_points=tflat.n, quota=120, k=10,
                                 corpora=(c, c), eps=eps, shards=s,
                                 mesh=mesh, device=CPU)
        runs.append(tct.CoverSearchResult(bm.ids, bm.dists, bm.D_calls))
        assert (bm.d_calls == 0).all()
        for i, res in enumerate(runs):
            for f in ref._fields:
                assert torch.equal(getattr(res, f), getattr(ref, f)), (
                    s, i, f)
    with pytest.raises(ValueError, match="corpora"):
        tbm.bimetric_search(None, fn, tflat, None, qs, n_points=tflat.n,
                            quota=120, shards=2, mesh=mesh, device=CPU)
    with pytest.raises(ValueError, match=r"search_mesh\(2, devices="):
        tct.search_corpus(tflat, corpus, queries, quota=50, shards=2,
                          device=CPU)
    with pytest.raises(ValueError, match="stepper is on cpu"):
        tct.search_batched(tflat, fn, qs, quota=50, stepper=stepper,
                           device="meta")


def test_entry_points_without_device_raise_on_cpu_host(parts):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: device=None means the card")
    _, _, tflat, corpus, queries = parts
    x, t = BUILDS["flat_parts"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tct.build(x, T=t)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tct.flatten(tct.build(x, T=t, device=CPU))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tct.search_corpus(tflat, corpus, queries, quota=50)


# --------------------------------------------------------------------------
# the engine pieces of the slice
# --------------------------------------------------------------------------
def _pool_dists(seed, b=6, p=12):
    rng = np.random.default_rng(seed)
    d = np.sort(rng.integers(0, 8, (b, p)).astype(np.float32) * 0.5, axis=1)
    d[1, 5:] = np.inf
    d[2] = np.inf  # an empty row
    d[3, 0] = d[3, 1]  # a tie at the minimum
    return d


@pytest.mark.parametrize("radius", [0.0, 0.5, 1.25, 3.0, np.inf, "rows"])
def test_frontier_count_matches_jax(radius):
    d = _pool_dists(4)
    r = (np.array([0.0, 1.0, np.inf, 0.5, 2.0, 0.7], np.float32)
         if radius == "rows" else radius)
    want = np.asarray(jops.frontier_count(
        jnp.asarray(d), jnp.asarray(r) if radius == "rows" else jnp.float32(r)))
    got = tops.frontier_count(torch.from_numpy(d),
                              torch.from_numpy(r) if radius == "rows" else r)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[2] == 0


def test_frontier_count_rounds_the_radius_to_f32():
    """A radius is compared in the pools' f32, as JAX's float32(radius)."""
    d = np.array([[1.0, np.float32(1.0) + np.float32(0.1)]], np.float32)
    r = 0.1000000001  # rounds to float32(0.1)
    want = np.asarray(jops.frontier_count(jnp.asarray(d), jnp.float32(r)))
    got = tops.frontier_count(torch.from_numpy(d), r)
    np.testing.assert_array_equal(got.numpy(), want)


def _states(seed, n=50, b=4, e0=3, p=10, quota=30, dedup="bitmap"):
    """One seeded state in each package: the entry wave committed."""
    rng = np.random.default_rng(seed)
    entries = rng.integers(0, n, (b, e0)).astype(np.int32)
    entries[0, 1] = -1
    d = rng.random((b, e0)).astype(np.float32)
    cap = quota if dedup == "sorted" else None
    js, safe, keep = jbeam.init_state(jnp.asarray(entries), n_points=n,
                                      pool_size=p, quota=quota, dedup=dedup,
                                      set_capacity=cap)
    js = jbeam.commit_scores(js, safe, keep, jnp.asarray(d))
    ts, safe, keep = tbeam.init_state(torch.from_numpy(entries), n_points=n,
                                      pool_size=p, quota=quota, dedup=dedup,
                                      set_capacity=cap)
    ts = tbeam.commit_scores(ts, safe, keep, torch.from_numpy(d))
    return js, ts


def _assert_state(js, ts):
    for f in ("pool_ids", "pool_dists", "expanded", "n_calls", "n_steps"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)


@pytest.mark.parametrize("rows", ["mask", True, False])
def test_reset_expanded_matches_jax(rows):
    js, ts = _states(1)
    flags = np.random.default_rng(2).random(ts.expanded.shape) < 0.5
    js = js._replace(expanded=jnp.asarray(flags))
    ts = ts._replace(expanded=torch.from_numpy(flags))
    r = np.array([True, False, True, False]) if rows == "mask" else rows
    js = jbeam.reset_expanded(js, jnp.asarray(r))
    ts = tbeam.reset_expanded(ts, torch.as_tensor(r))
    _assert_state(js, ts)


@pytest.mark.parametrize("dedup", ["bitmap", "sorted"])
@pytest.mark.parametrize("quota", [4, 30])
def test_plan_step_level_matches_jax(dedup, quota):
    """Rows at different levels of an (L, N, R) table plan JAX's wave, with
    and without the same-wave dedup; a frozen row plans nothing."""
    rng = np.random.default_rng(quota)
    table = rng.integers(-1, 50, (3, 50, 5)).astype(np.int32)
    table[1, 7] = -1  # a row absent from its level
    for wave_dedup in (True, False):
        js, ts = _states(3, quota=quota, dedup=dedup)
        lev = np.array([0, 2, 1, 1], np.int32)
        ew = np.array([3, 1, 0, 2], np.int32)
        kw = dict(beam_width=10, quota=quota, max_steps=100, expand_cap=3,
                  wave_dedup=wave_dedup)
        jw = jbeam.plan_step(js, jnp.asarray(table), level=jnp.asarray(lev),
                             expand_width=jnp.asarray(ew), **kw)
        tw = tbeam.plan_step(ts, torch.from_numpy(table),
                             level=torch.from_numpy(lev),
                             expand_width=torch.from_numpy(ew), **kw)
        _assert_state(jw[0], tw[0])
        for a, b in zip(jw[1:], tw[1:]):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        assert (tw[2].sum(1).numpy() <= quota).all()


def test_plan_step_without_level_is_unchanged():
    """``level=None`` reads the flat graph as before: the same wave as
    ``level=0`` of a one-slab table."""
    adj = np.random.default_rng(6).integers(-1, 50, (50, 5)).astype(np.int32)
    kw = dict(beam_width=10, quota=30, max_steps=100, expand_width=2)
    _, ts = _states(5)
    flat = tbeam.plan_step(ts, torch.from_numpy(adj), **kw)
    _, ts = _states(5)
    slab = tbeam.plan_step(ts, torch.from_numpy(adj[None]), level=0, **kw)
    for a, b in zip(flat[1:], slab[1:]):
        assert torch.equal(a, b)
