"""The port's ``beam.ShardedStepper`` against the unsharded primitives.

The stepper is the host-driven form of the sharded engine (the serving
engine's stage 2, the cover-tree descent): its methods are ``init_state``,
``plan_step``, ``commit_scores``, ``reset_slots``, ``reset_expanded`` and
``active_mask`` called with a ``ShardCtx``. On ``["cpu"] * S`` meshes, a
drive through it must equal the same drive through the primitives bit for
bit (pool ids, dists, ``n_calls``, ``n_steps``) under both dedup backends,
at uneven N, and its counts must hold the two invariants of
``tests/test_beam_batched.py::test_sharded_dedup_backend_parity``: the
bitmap's slices partition it (their popcounts sum to the scored count) and
the replicated sorted set counts the same ids. JAX's own stepper is held
against the port in ``tests/test_torch_sharding.py``. No jax here.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import beam
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import SearchMesh, search_mesh
from repro_torch.kernels import ops

CPU = "cpu"
B = 5


def _stepper(shards, n):
    mesh = search_mesh(shards, devices=[CPU] * shards)
    return beam.ShardedStepper(shards=shards, n_points=n, mesh=mesh,
                               device=CPU)


def _graph(n, r=6, dim=8, seed=0):
    """A ragged graph whose rows hold distinct ids, so that one paid call
    is one distinct scored id (``n_calls`` == the scored count)."""
    rng = np.random.default_rng(seed + n)
    adj = np.stack([rng.choice(n, r, replace=False) for _ in range(n)])
    adj[rng.random((n, r)) < 0.2] = -1
    emb = torch.from_numpy(rng.normal(size=(n, dim)).astype(np.float32))
    qs = torch.from_numpy(rng.normal(size=(B, dim)).astype(np.float32))
    return torch.from_numpy(adj.astype(np.int32)), emb, qs


def _entries(n):
    return torch.tensor([[0, n // 2, n - 1]] * B, dtype=torch.int32)


class _Plain:
    """The unsharded primitives behind the stepper's method names."""

    def init(self, entries, quota, *, pool_size, dedup, set_capacity):
        return beam.init_state(entries, n_points=self.n, pool_size=pool_size,
                               quota=quota, dedup=dedup,
                               set_capacity=set_capacity)

    def plan(self, state, adj, quota, bw, ms, **kw):
        return beam.plan_step(state, adj, beam_width=bw, quota=quota,
                              max_steps=ms, **kw)

    def commit(self, state, safe, keep, d):
        return beam.commit_scores(state, safe, keep, d)

    def active_any(self, state, quota, bw, ms):
        return bool(beam.active_mask(state, beam_width=bw, quota=quota,
                                     max_steps=ms).any())


def _plain(n):
    p = _Plain()
    p.n = n
    return p


def _drive(st, adj, fn, qs, entries, quota, dedup, cap, *, bw=8, ms=60,
           ew=1):
    """The engine's stage-2 shape: plan, score, commit until no row is
    active."""
    state, safe, keep = st.init(entries, quota, pool_size=16, dedup=dedup,
                                set_capacity=cap)
    while True:
        state = st.commit(state, safe, keep, fn(qs, safe))
        if not st.active_any(state, quota, bw, ms):
            return state
        state, safe, keep, _ = st.plan(state, adj, quota, bw, ms,
                                       expand_width=ew)


def _assert_same(got, want, what):
    for name in ("pool_ids", "pool_dists", "n_calls", "n_steps"):
        assert torch.equal(getattr(got, name), getattr(want, name)), (
            what, name)


@pytest.mark.parametrize("quota", [1, 17, "n"])
@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("n", [130, 97])
def test_stepper_drive_matches_primitives(n, shards, quota):
    """Both backends, quotas {1, 17, N}, a (B,) expand width: the stepper's
    drive equals the unsharded bitmap drive, the bitmap's slice popcounts
    sum to the scored count, and the sorted set's distinct count is the
    same number."""
    q = n if quota == "n" else quota
    adj, emb, qs = _graph(n)
    fn = beam.fused_dist_fn(emb, "l2")
    ew = torch.tensor([1, 2, 1, 3, 2], dtype=torch.int32)
    base = _drive(_plain(n), adj, fn, qs, _entries(n), q, "bitmap", None,
                  ew=ew)
    count = base.scored.sum(dim=1, dtype=torch.int32)
    assert torch.equal(count, base.n_calls)
    st = _stepper(shards, n)
    for dedup, cap in (("bitmap", None), ("sorted", q)):
        got = _drive(st, adj, fn, qs, _entries(n), q, dedup, cap, ew=ew)
        _assert_same(got, base, (dedup, shards))
        assert torch.equal(st.scored_count(got), got.n_calls), dedup
        if dedup == "bitmap":
            assert len(got.scored) == shards
            assert all(t.shape == (B, st.n_local) for t in got.scored)
            whole = torch.cat(got.scored, dim=1)
            assert torch.equal(whole[:, :n], base.scored)
            assert not whole[:, n:].any()  # pad columns never marked
            assert torch.equal(collectives.bitmap_count(got.scored), count)
        else:
            assert torch.equal(collectives.member_count(got.scored.ids),
                               count)


@pytest.mark.parametrize("dedup,cap", [("bitmap", None), ("sorted", 32)])
@pytest.mark.parametrize("shards", [2, 4])
def test_admit_resets_rows_like_fresh_init(shards, dedup, cap):
    """``admit`` (``reset_slots(shard=)``) on a mixed reset mask: the input
    state is unchanged, the other rows pass bit for bit, and the reset rows
    then search as a fresh ``init`` does."""
    n = 97
    adj, emb, qs = _graph(n, seed=1)
    fn = beam.fused_dist_fn(emb, "l2")
    st = _stepper(shards, n)
    quota = torch.tensor([10, 14, 0, 7, 20], dtype=torch.int32)
    state = _drive(st, adj, fn, qs, _entries(n), quota, dedup, cap)
    snap = [tuple(t.clone() for t in leaf) if isinstance(leaf, tuple)
            else leaf for leaf in state]
    if dedup == "sorted":
        snap[3] = beam.ScoredSet(state.scored.ids.clone(),
                                 state.scored.count.clone())
    reset = torch.tensor([False, True, False, True, True])
    new_entries = torch.tensor([[2, 7, 2]] * B, dtype=torch.int32)
    new_quota = torch.tensor([10, 9, 0, 12, 1], dtype=torch.int32)
    st2, safe2, keep2 = st.admit(state, reset, new_entries, new_quota)
    # the input state is not modified
    if dedup == "bitmap":
        for a, b in zip(state.scored, snap[3]):
            assert torch.equal(a, b)
    else:
        assert torch.equal(state.scored.ids, snap[3].ids)
    keep_rows = torch.tensor([0, 2])
    for leaf, old in zip(st2[:3] + st2[4:], state[:3] + state[4:]):
        assert torch.equal(leaf[keep_rows], old[keep_rows])
    if dedup == "bitmap":
        for a, b in zip(st2.scored, state.scored):
            assert torch.equal(a[keep_rows], b[keep_rows])
    assert not keep2[keep_rows].any()
    # the reset rows: the entry wave and the search of a fresh init
    fresh, fsafe, fkeep = st.init(new_entries, new_quota, pool_size=16,
                                  dedup=dedup, set_capacity=cap)
    rows = torch.tensor([1, 3, 4])
    assert torch.equal(safe2[rows], fsafe[rows])
    assert torch.equal(st.scored_count(st2)[rows],
                       st.scored_count(fresh)[rows])

    def finish(s, safe, keep):
        while True:
            s = st.commit(s, safe, keep, fn(qs, safe))
            if not st.active_any(s, new_quota, 8, 60):
                return s
            s, safe, keep, _ = st.plan(s, adj, new_quota, 8, 60)

    got = finish(st2, safe2, keep2)
    want = finish(fresh, fsafe, fkeep)
    for name in ("pool_ids", "pool_dists", "n_calls", "n_steps"):
        assert torch.equal(getattr(got, name)[rows],
                           getattr(want, name)[rows]), name
    # the primitive at shards=1 recycles the same rows the same way
    plain = _drive(_plain(n), adj, fn, qs, _entries(n), quota, dedup, cap)
    _, psafe, pkeep = beam.reset_slots(plain, reset, new_entries, new_quota)
    assert torch.equal(psafe, safe2) and torch.equal(pkeep, keep2)


def test_grow_and_early_resolve_pass_the_slices_through():
    """Neither touches a bitmap: the tuple of slices is the same object."""
    n = 97
    adj, emb, qs = _graph(n, seed=2)
    st = _stepper(4, n)
    state = _drive(st, adj, beam.fused_dist_fn(emb, "l2"), qs, _entries(n),
                   12, "bitmap", None)
    grown = beam.grow_state(state, pool_size=32, set_capacity=64)
    assert grown.scored is state.scored and grown.pool_ids.shape[1] == 32
    closed = beam.early_resolve(state, torch.tensor([True, False] * 2 +
                                                    [True]))
    assert closed.scored is state.scored
    act = st.active(closed, 99, 16, 99)
    assert not act[[0, 2, 4]].any()


@pytest.mark.parametrize("dedup,cap", [("bitmap", None), ("sorted", 30)])
@pytest.mark.parametrize("shards", [2, 4])
def test_reopen_and_level_plans(shards, dedup, cap):
    """``reopen`` and ``plan(level=)`` on a level-stacked (L, N, R) table,
    with and without the same-wave dedup: every wave, the state and the
    counts equal the unsharded primitives'."""
    n = 97
    rng = np.random.default_rng(shards)
    table = torch.from_numpy(rng.integers(-1, n, (3, n, 5)).astype(np.int32))
    emb = torch.from_numpy(rng.normal(size=(n, 8)).astype(np.float32))
    qs = torch.from_numpy(rng.normal(size=(B, 8)).astype(np.float32))
    fn = beam.fused_dist_fn(emb, "l2")
    st = _stepper(shards, n)
    quota = torch.tensor([4, 30, 30, 12, 0], dtype=torch.int32)
    lev = torch.tensor([0, 2, 1, 1, 0], dtype=torch.int32)
    for wave_dedup in (True, False):
        states = []
        for s in (_plain(n), st):
            state, safe, keep = s.init(_entries(n), quota, pool_size=12,
                                       dedup=dedup, set_capacity=cap)
            states.append(s.commit(state, safe, keep, fn(qs, safe)))
        for t in range(3):
            ew = torch.tensor([3, 1, 0, 2, 1], dtype=torch.int32)
            rows = torch.tensor([True, t != 1, True, False, True])
            plain = beam.reset_expanded(states[0], rows)
            shard = st.reopen(states[1], rows)
            assert torch.equal(plain.expanded, shard.expanded)
            kw = dict(expand_width=ew, expand_cap=3, level=(lev + t) % 3,
                      wave_dedup=wave_dedup)
            pw = _plain(n).plan(plain, table, quota, 12, 99, **kw)
            sw = st.plan(shard, table, quota, 12, 99, **kw)
            for a, b in zip(pw[1:], sw[1:]):
                assert torch.equal(a, b)
            states = [s.commit(w[0], w[1], w[2], fn(qs, w[1]))
                      for s, w in ((_plain(n), pw), (st, sw))]
            _assert_same(states[1], states[0], (wave_dedup, t))
            assert torch.equal(st.scored_count(states[1]),
                               st.scored_count(states[0]))
        assert (states[1].n_calls <= quota).all()


def test_stepper_mesh_rules():
    """Without ``mesh=`` a CPU host has one device: raise and name the
    ``search_mesh(S, devices=...)`` form. A mesh of the wrong size or of
    another device type raises; ``shards=1`` needs no mesh."""
    with pytest.raises(ValueError, match=r"search_mesh\(2, devices="):
        beam.ShardedStepper(shards=2, n_points=97, device=CPU)
    with pytest.raises(ValueError, match="mesh has 3"):
        beam.ShardedStepper(shards=2, n_points=97, device=CPU,
                            mesh=search_mesh(3, devices=[CPU] * 3))
    meta = SearchMesh((torch.device("meta"),) * 2)
    mixed = SearchMesh((torch.device("cpu"), torch.device("meta")))
    for mesh in (meta, mixed):
        with pytest.raises(ValueError, match="runs on cpu"):
            beam.ShardedStepper(shards=2, n_points=97, device=CPU, mesh=mesh)
    one = beam.ShardedStepper(shards=1, n_points=97, device=CPU)
    assert one.ctx is None and one.device == torch.device(CPU)
    st = _stepper(4, 97)
    assert st.n_local == 25 and st.ctx.devices == (torch.device(CPU),) * 4


def test_counts_are_the_invariants():
    """``bitmap_count`` sums the slices' popcounts in shard order;
    ``member_count`` collapses the sorted set's duplicate slots."""
    slices = (torch.tensor([[1, 0, 1], [0, 0, 0]], dtype=torch.bool),
              torch.tensor([[1, 1, 0], [1, 0, 0]], dtype=torch.bool))
    assert collectives.bitmap_count(slices).tolist() == [4, 1]
    pad = ops.SET_PAD
    ids = torch.tensor([[3, 3, 8, pad], [pad, pad, pad, pad]],
                       dtype=torch.int32)
    assert collectives.member_count(ids).tolist() == [2, 0]
