"""The port's GAT (``repro_torch.models.gnn``, ``configs/gat_cora.py``)
against ``repro.models.gnn`` and ``repro.configs.gat_cora``.

The same weights cross as numpy arrays into both (the port's module through
``convert.gat_from_numpy``), and the same numpy graphs go through JAX's
functions and the port's on CPU tensors. The bias is drawn nonzero here
(JAX starts it at 0): both sides must ignore it, and its gradient is 0.

Tolerances: forward and loss in f32 within atol 2e-5 and rtol 2e-4 (JAX's
``test_models.py``); bf16 logits within 2e-2 x max |logit|; a gradient per
leaf within 1e-4 x that leaf's max |gradient|.

JAX's references are computed once per case (one compiled forward, loss
and gradient each) in a module-scoped fixture, compiled at XLA's lowest
backend optimisation level: the same operations, compiled in half the
time.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import gat_cora as jgat
from repro.models import gnn as JG
from repro.train.optimizer import AdamWConfig as JAdamWConfig
from repro_torch import convert
from repro_torch.configs import gat_cora as tgat
from repro_torch.models import gnn as G

CPU = "cpu"
ATOL, RTOL = 2e-5, 2e-4
GRAD_REL = 1e-4
BF16_REL = 2e-2
#: ``tests/test_models.py``'s GAT sizes, and the four smoke shapes
CASES = ("small", *jgat.SMOKE_SHAPES)
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _info(case):
    if case == "small":
        return dict(n_nodes=20, n_edges=60, d_feat=8, n_classes=3,
                    task="node")
    return jgat.SMOKE_SHAPES[case]


def _cfgs(case, dtype="float32"):
    """(JAX's config, the port's) of ``case``."""
    info = _info(case)
    kw = dict(d_in=info["d_feat"], n_classes=info["n_classes"])
    if case == "small":
        kw.update(n_heads=2, d_hidden=4)
    jcfg = JG.GATConfig(**kw, dtype=getattr(jnp, dtype))
    return jcfg, G.GATConfig(**kw, dtype=getattr(torch, dtype))


def _params(jcfg, seed=0, dtype=np.float32):
    """JAX's tree at JAX's scales, drawn with numpy; the bias nonzero."""
    rng = np.random.default_rng(seed)
    out, d_in = [], jcfg.d_in
    for i in range(jcfg.n_layers):
        last = i == jcfg.n_layers - 1
        d_out = jcfg.n_classes if last else jcfg.d_hidden
        hd = jcfg.n_heads * d_out
        out.append({k: v.astype(dtype) for k, v in dict(
            w=rng.standard_normal((d_in, hd)) / np.sqrt(d_in),
            a_src=0.1 * rng.standard_normal((jcfg.n_heads, d_out)),
            a_dst=0.1 * rng.standard_normal((jcfg.n_heads, d_out)),
            bias=0.1 * rng.standard_normal(hd)).items()})
        d_in = d_out if last else hd
    return {"layers": out}


def _batch(case, seed=1):
    """Random edges with the edge semantics in them: the last eighth are
    padding (-1), one edge has ``dst = -1`` (it lands on node 0), and node
    n-1 has no in-edge. Graph task: ids by blocks of nodes, one -1 and one
    ``n_graphs`` (both dropped)."""
    info = _info(case)
    n, e, f = info["n_nodes"], info["n_edges"], info["d_feat"]
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n - 1, e).astype(np.int32)
    src[-(e // 8):] = -1
    dst[-(e // 8):] = -1
    dst[0] = -1
    batch = {"feats": rng.standard_normal((n, f)).astype(np.float32),
             "src": src, "dst": dst}
    if info["task"] == "node":
        batch["labels"] = rng.integers(0, info["n_classes"], n).astype(
            np.int32)
        batch["mask"] = (rng.random(n) < 0.7).astype(np.float32)
    else:
        ng = info["n_graphs"]
        gid = (np.arange(n) * ng // n).astype(np.int32)
        gid[3], gid[5] = -1, ng
        batch["graph_ids"] = gid
        batch["graph_labels"] = rng.integers(0, info["n_classes"], ng).astype(
            np.int32)
    return batch


def _compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)


def _jax_refs(case, params, batch):
    jcfg, _ = _cfgs(case)
    info = _info(case)
    loss = functools.partial(jgat.graph_loss, cfg=jcfg, task=info["task"],
                             n_graphs=info.get("n_graphs") or 0)

    def run(p, b):
        (l, _), g = jax.value_and_grad(loss, has_aux=True)(p, b)
        return JG.forward(p, b["feats"], b["src"], b["dst"], jcfg), l, g

    logits, l, g = _compiled(run, params, batch)(params, batch)
    return np.asarray(logits), float(l), jax.tree.map(np.asarray, g)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The graphs here are tiny: torch's intra-op threads cost more than
    they save, most of all when the suite runs its files side by side
    (the twin's index build took 22 s with six copies of this file running
    against 0.6 s alone). Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def refs():
    """{case: (params, batch, JAX's logits, loss, gradients)}."""
    out = {}
    for case in CASES:
        params, batch = _params(_cfgs(case)[0]), _batch(case)
        out[case] = (params, batch, *_jax_refs(case, params, batch))
    return out


def _torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _port(case, params, batch, chunk=None):
    """The port's (logits, loss, gradient tree); the bias's gradient, which
    autograd reports as unused, as zeros (what the ``Trainer`` fills)."""
    model = convert.gat_from_numpy(params, _cfgs(case)[1], device=CPU)
    b = _torch(batch)
    info = _info(case)
    loss, _ = tgat.graph_loss(model, b, task=info["task"],
                              n_graphs=info.get("n_graphs") or 0, chunk=chunk)
    names, leaves = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    assert all((g is None) == n.endswith("bias") for n, g in zip(names,
                                                                 grads))
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    with torch.no_grad():
        logits = G.forward(model, b["feats"], b["src"], b["dst"], chunk=chunk)
    return logits.numpy(), float(loss.detach()), convert.gat_to_numpy(
        dict(zip(names, grads)))


def _grads_close(got, want):
    got, want = convert._flatten(got), convert._flatten(want)
    assert got.keys() == want.keys()
    for path, w in want.items():
        err = float(np.abs(got[path] - w).max())
        assert err <= GRAD_REL * float(np.abs(w).max()), (path, err)
        if path.endswith("bias"):
            assert not w.any() and not got[path].any(), path


# --------------------------------------------------------------------------
# configs and conversion
# --------------------------------------------------------------------------
@pytest.mark.parametrize("shape", list(jgat.GNN_SHAPES))
def test_configs_are_jax_field_for_field(shape):
    """The shape tables, the default config, and each shape's config as
    ``build_gnn_cell`` makes it (JAX's ``gat_cora.py:76-79``)."""
    assert tgat.GNN_SHAPES == jgat.GNN_SHAPES
    assert tgat.SMOKE_SHAPES == jgat.SMOKE_SHAPES
    for which, table in (("full", jgat.GNN_SHAPES),
                         ("smoke", jgat.SMOKE_SHAPES)):
        info = table[shape]
        want = dataclasses.asdict(JG.GATConfig(
            name="gat", n_layers=2, d_hidden=8, n_heads=8,
            d_in=info["d_feat"], n_classes=info["n_classes"]))
        got = dataclasses.asdict(getattr(tgat, which)(shape))
        assert str(got.pop("dtype")).split(".")[-1] == jnp.dtype(
            want.pop("dtype")).name
        assert got == want
    want = dataclasses.asdict(JG.GATConfig())
    got = dataclasses.asdict(G.GATConfig())
    assert str(got.pop("dtype")) == "torch.float32" and want.pop("dtype")
    assert got == want
    assert dataclasses.asdict(tgat.OPT) == dataclasses.asdict(
        JAdamWConfig(weight_decay=0.0))


def test_init_and_round_trip_through_jax():
    """The port's initialiser gives JAX's tree, shapes and dtypes (bias 0,
    the attention vectors at 0.1's scale); JAX's tree -> the port -> JAX's
    tree is exact; a missing leaf raises."""
    jcfg, tcfg = _cfgs("full_graph_sm")
    got = convert.gat_to_numpy(G.init_params(0, tcfg, device=CPU))
    want = jax.eval_shape(lambda k: JG.init_params(k, jcfg),
                          jax.random.PRNGKey(0))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype
    for layer in got["layers"]:
        assert not layer["bias"].any()
        assert 0.07 < layer["a_src"].std() < 0.13
    params = _params(jcfg)
    back = convert.gat_to_numpy(convert.gat_from_numpy(params, tcfg,
                                                       device=CPU))
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    del params["layers"][1]["bias"]
    with pytest.raises(ValueError, match="only one of"):
        convert.gat_from_numpy(params, tcfg, device=CPU)


# --------------------------------------------------------------------------
# forward, loss and gradients
# --------------------------------------------------------------------------
@pytest.mark.parametrize("case", CASES)
def test_forward_loss_and_grads_match_jax(refs, case):
    """At ``test_models.py``'s sizes and the four smoke shapes (molecule:
    ``graph_loss``'s readout, two ids outside [0, n_graphs))."""
    params, batch, logits, loss, grads = refs[case]
    got_logits, got_loss, got_grads = _port(case, params, batch)
    np.testing.assert_allclose(got_logits, logits, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got_loss, loss, atol=ATOL, rtol=RTOL)
    _grads_close(got_grads, grads)


@pytest.mark.parametrize("case,chunk", [("small", 7), ("minibatch_lg", 100),
                                        ("molecule", 129)])
def test_chunked_route_matches_jax(refs, case, chunk):
    """Messages in chunks smaller than E (runs split across chunks are
    added in chunk order): forward, loss and gradients still JAX's."""
    params, batch, logits, loss, grads = refs[case]
    assert chunk < batch["src"].shape[0]
    got_logits, got_loss, got_grads = _port(case, params, batch, chunk=chunk)
    np.testing.assert_allclose(got_logits, logits, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got_loss, loss, atol=ATOL, rtol=RTOL)
    _grads_close(got_grads, grads)
    whole = _port(case, params, batch)[0]
    np.testing.assert_allclose(got_logits, whole, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("case,chunk", [("small", 7), ("minibatch_lg", 100),
                                        ("molecule", 129)])
def test_recomputed_chunks_match_saved_whole_and_jax(refs, case, chunk):
    """The backward that recomputes the softmax and each chunk (what grad
    runs in more than one chunk), in several chunks: its gradient equals
    the one-chunk gradient, autograd's saved form, within 1e-6 of each
    leaf's max |gradient|, and ``jax.grad`` of JAX's ``graph_loss`` within
    the file's tolerance; its loss equals the one-chunk loss bit for
    bit."""
    params, batch, _, loss, grads = refs[case]
    assert chunk * 2 < batch["src"].shape[0]
    _, got_loss, got = _port(case, params, batch, chunk=chunk)
    _grads_close(got, grads)
    _, whole_loss, whole = _port(case, params, batch)
    assert got_loss == whole_loss
    np.testing.assert_allclose(got_loss, loss, atol=ATOL, rtol=RTOL)
    got = convert._flatten(got)
    for path, w in convert._flatten(whole).items():
        assert np.abs(got[path] - w).max() <= 1e-6 * np.abs(w).max(), path


def test_forward_bf16_matches_jax(refs):
    params, batch = refs["full_graph_sm"][:2]
    jcfg, tcfg = _cfgs("full_graph_sm", "bfloat16")
    p16 = jax.tree.map(lambda a: a.astype(ml_dtypes.bfloat16), params)
    fwd = lambda p, b: JG.forward(p, b["feats"], b["src"], b["dst"], jcfg)
    want = np.asarray(_compiled(fwd, p16, batch)(p16, batch), np.float32)
    model = convert.gat_from_numpy(p16, tcfg, device=CPU)
    b = _torch(batch)
    with torch.no_grad():
        got = G.forward(model, b["feats"], b["src"], b["dst"])
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    assert err <= BF16_REL * np.abs(want).max(), err


# --------------------------------------------------------------------------
# JAX's edge semantics
# --------------------------------------------------------------------------
def _forward(case, params, batch, **changes):
    b = _torch({**batch, **changes})
    model = convert.gat_from_numpy(params, _cfgs(case)[1], device=CPU)
    with torch.no_grad():
        return G.forward(model, b["feats"], b["src"], b["dst"]).numpy()


def test_padding_edges_and_empty_nodes(refs):
    """Padding edges change nothing; node n-1, with no in-edge, has
    output 0 on both sides; a layer's softmax skips invalid edges."""
    params, batch, logits = refs["small"][:3]
    keep = batch["src"] >= 0
    bare = _forward("small", params, batch, src=batch["src"][keep],
                    dst=batch["dst"][keep])
    np.testing.assert_allclose(bare, logits, atol=ATOL, rtol=RTOL)
    assert not (batch["dst"][keep] == 19).any()
    assert not logits[19].any() and not _forward("small", params, batch)[
        19].any()


def test_dst_minus_one_lands_on_node_zero(refs):
    """An edge with ``src >= 0`` and ``dst = -1`` is valid and counts at
    node 0, as in JAX (``max(dst, 0)``)."""
    params, batch, logits = refs["small"][:3]
    assert batch["src"][0] >= 0 and batch["dst"][0] == -1
    as_zero = _forward("small", params, batch,
                       dst=np.where(np.arange(60) == 0, 0, batch["dst"]))
    np.testing.assert_array_equal(_forward("small", params, batch), as_zero)
    np.testing.assert_allclose(as_zero, logits, atol=ATOL, rtol=RTOL)
    dropped = _forward("small", params, batch,
                       src=np.where(np.arange(60) == 0, -1, batch["src"]))
    assert np.abs(dropped[0] - logits[0]).max() > 1e-3


def test_graph_ids_outside_range_are_dropped(refs):
    """``graph_loss``'s readout drops ids -1 and ``n_graphs`` (JAX's
    ``segment_sum``); giving those nodes an id inside the range changes
    the loss."""
    params, batch, _, loss = refs["molecule"][:4]
    model = convert.gat_from_numpy(params, _cfgs("molecule")[1], device=CPU)
    fn = functools.partial(tgat.graph_loss, task="graph", n_graphs=8)
    with torch.no_grad():
        got = float(fn(model, _torch(batch))[0])
        gid = batch["graph_ids"].copy()
        gid[3] = gid[5] = 0
        moved = float(fn(model, _torch({**batch, "graph_ids": gid}))[0])
    np.testing.assert_allclose(got, loss, atol=ATOL, rtol=RTOL)
    assert abs(moved - got) > 1e-6


def test_edge_order_invariance(refs):
    """JAX's ``test_gat_edge_order_invariance``: a permutation of the edges
    moves the sums' order only."""
    params, batch, logits = refs["small"][:3]
    perm = np.random.default_rng(2).permutation(60)
    got = _forward("small", params, batch, src=batch["src"][perm],
                   dst=batch["dst"][perm])
    np.testing.assert_allclose(got, logits, atol=ATOL, rtol=RTOL)


# --------------------------------------------------------------------------
# the sampler, the launcher, the corpus-search twin
# --------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 3])
def test_graph_and_sampler_bit_equal_to_jax(seed):
    want = JG.random_csr_graph(500, 8, 16, 5, seed=seed)
    got = G.random_csr_graph(500, 8, 16, 5, seed=seed)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    blocks = [mod.sample_block(g, np.arange(32) * 7, (5, 3),
                               np.random.default_rng(seed))
              for mod, g in ((G, got), (JG, want))]
    for a, b in zip(*blocks):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    blk = blocks[0]
    assert blk.mask.sum() == 32 and (blk.dst[blk.src >= 0] >= 0).all()


def test_train_launcher_refuses_gat_cora():
    """With JAX's message (its launcher drives the LM family only); the
    launcher resolves every arch through the registry, none is left to a
    later item."""
    from repro_torch.launch import train as launch_train

    with pytest.raises(SystemExit, match="drives the LM family"):
        launch_train.main(["--arch", "gat-cora", "--device", CPU])
    assert not hasattr(launch_train, "LATER")


def test_corpus_search_twin_on_the_cpu():
    """``launch/gnn_corpus_search.main`` at N=256: each query within its
    quota of D calls, recall@10 a share."""
    from repro_torch.launch import gnn_corpus_search

    out = gnn_corpus_search.main(["--n-nodes", "256", "--device", CPU])
    for quota in (64, 256):
        assert len(out["D_calls"][quota]) == 16
        assert max(out["D_calls"][quota]) <= quota
        assert 0.0 <= out["recall_at_10"][quota] <= 1.0
