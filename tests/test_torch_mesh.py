"""Training on a (data, model) mesh in the port (``launch/mesh.py``,
``distributed/sharding.py``'s specs and placement, the cells'
``abstract_args(mesh)``, the train step on placed arguments,
``compression.quantized_psum``) against ``repro``:

* every cell's argument specs equal JAX's, leaf for leaf through
  ``convert.specs_from_jax``, for every registered arch at its full config
  on (16, 16), (2, 16, 16) and (2, 2) meshes (abstract: shapes only);
* ``shard_tensor`` and ``gather_tensor`` are inverse, block shapes right;
* qwen3's smoke train cell on ``["cpu"] * 4`` meshes against the port's
  unsharded step (the JAX mesh itself: the subprocess of
  ``tests/test_torch_sharding.py``);
* the mesh constructors, and ``quantized_psum`` within its bound.
"""
import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import configs as JC
from repro.configs import gat_cora as jgat
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.configs import common
from repro_torch.configs import gat_cora as tgat
from repro_torch.configs.lm_common import SMOKE_SHAPES, build_lm_cell
from repro_torch.distributed import sharding as shr
from repro_torch.launch import mesh as M
from repro_torch.train import compression
from repro_torch.train.optimizer import AdamWConfig, AdamWState, make_adamw

CPU = "cpu"
NAMES = [*JC.ARCHS, *JC.EXTRA_ARCHS]
MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((2, 2), ("data", "model"))]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small shapes: torch's intra-op threads cost more than they save when
    the suite runs its files side by side. Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cells(mod, name):
    spec = mod.get_arch(name)
    if name == "gat-cora":
        gat = jgat if mod is JC else tgat
        return {s: gat.build_gnn_cell(None, s) for s in spec.shapes}
    return spec.cells()


def _port_specs(tree):
    """The spec of each abstract leaf (the port's ``arg_shardings``)."""
    return shr.tree_map(lambda s: None if s is None else s.spec,
                        common.arg_shardings(tree))


@pytest.mark.parametrize("shape,axes", MESHES, ids=["16x16", "2x16x16",
                                                    "2x2"])
@pytest.mark.parametrize("name", NAMES)
def test_cell_specs_are_jaxs(name, shape, axes):
    """Every cell of the arch at its full config: the weights', the
    optimizer state's, the batch's and the decode cache's specs (the train
    cell's ``out_shardings`` too), each leaf JAX's."""
    jmesh = AbstractMesh(shape, axes)
    mesh = M.Mesh(shape, axes)
    cfg = TC.get_arch(name).make_config(False)
    got_cells, want_cells = _cells(TC, name), _cells(JC, name)
    for cell_name, cell in got_cells.items():
        jargs = want_cells[cell_name].abstract_args(jmesh)
        args = cell.abstract_args(mesh)
        assert len(args) == len(jargs), cell_name
        for i, (a, ja) in enumerate(zip(args, jargs)):
            want = convert.specs_from_jax(
                jax.tree.map(lambda x: x.sharding.spec, ja),
                cfg if TC.get_arch(name).family == "lm" else None)
            got = _port_specs(a)
            if isinstance(want, AdamWState):
                # the port's step is a host int, JAX's a replicated scalar
                assert want.step == () and a.step == 0 and got.step is None
                got, want = got._replace(step=()), want._replace(step=())
            if isinstance(got, dict) and isinstance(want, dict):
                assert got.keys() == want.keys(), (cell_name, i)
            assert got == want, (cell_name, i)
        if cell.entry == "train":
            out = cell.out_shardings(args)
            assert out[0] == common.arg_shardings(args[0])
            assert out[1] == common.arg_shardings(args[1])


def test_param_specs_split_as_jax_rules():
    """Spot checks of the rules: qwen3's embedding (vocab over model, d
    over data), a layer's wq (d over data, heads over model), a norm
    replicated, the recommenders' list of blocks read as JAX reads it."""
    mesh = M.Mesh((2, 16, 16), ("pod", "data", "model"))
    cfg = TC.get_arch("qwen3-0.6b").make_config(False)
    specs = shr.lm_param_specs(common.abstract_params(
        TC.get_arch("qwen3-0.6b").model, cfg), mesh, fsdp=("pod", "data"))
    assert specs["embed"] == shr.P("model", ("pod", "data"))
    assert specs["blocks.3.attn.wq"] == shr.P(("pod", "data"), "model")
    assert specs["blocks.3.attn.wo"] == shr.P("model", ("pod", "data"))
    assert specs["blocks.3.ln1"] == shr.P(None)
    assert shr.P("data", ("model",), ()) == ("data", "model", None)


def test_shard_then_gather_is_identity():
    """Each block is its slice of the tensor (the first axis major in a
    tuple of axes); a dimension an axis does not divide is replicated by
    ``_maybe`` and raises when a spec asks to split it; replicas get
    replica ids past 0 and are read once."""
    mesh = M.make_mesh((2, 2), ("data", "model"), [CPU] * 4)
    t = torch.arange(6 * 10 * 3, dtype=torch.float32).reshape(6, 10, 3)
    for spec, block in [(shr.P("data", "model"), (3, 5, 3)),
                        (shr.P(None, "model"), (6, 5, 3)),
                        (shr.P(), (6, 10, 3)),
                        (shr.P("model", None, None), (3, 10, 3))]:
        sh = shr.NamedSharding(mesh, spec)
        blocks = shr.shard_tensor(t, sh)
        assert [tuple(b.shape) for b in blocks] == [block] * 4
        assert torch.equal(shr.gather_tensor(blocks, sh), t)
        for pos, b in zip(mesh.positions(), blocks):
            assert torch.equal(b, t[sh.block_slices(t.shape, pos)])
    # (data, model) over the first dim: position (d, m) holds block 2d + m
    mesh4 = M.make_mesh((2, 2), ("data", "model"), [CPU] * 4)
    u = torch.arange(8.0)
    blocks = shr.shard_tensor(u, shr.NamedSharding(mesh4, shr.P(("data",
                                                                 "model"))))
    assert [b.tolist() for b in blocks] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    # 3 does not split two ways: the rule replicates, a spec that asks raises
    assert shr._maybe(3, "data", mesh) is None
    with pytest.raises(ValueError, match="does not split"):
        shr.shard_tensor(t, shr.NamedSharding(mesh, shr.P(None, None,
                                                          "model")))
    rep = shr.NamedSharding(mesh, shr.P(None, None, None))
    placed = shr.Placed(shr.shard_tensor(t, rep), rep)
    assert [rep.replica_id(p) for p in mesh.positions()] == [0, 1, 2, 3]
    assert len(placed.unique_blocks()) == 1 and placed.shape == (6, 10, 3)


def _train_state(cell, mesh, seed=0, opt_cfg=AdamWConfig(),
                 arch="qwen3-0.6b", batch_rows=None, cfg=None):
    """``arch``'s smoke weights (qwen3's by default; ``cfg`` if given) from
    a seed on the CPU, AdamW's state, a batch from numpy; the same placed
    by ``abstract_args(mesh)``'s shardings."""
    from repro_torch.models import transformer as T

    cfg = cfg or TC.get_arch(arch).make_config(True)
    model = T.init_params(seed, cfg, device=CPU)
    opt = make_adamw(opt_cfg)[0](model)
    info = SMOKE_SHAPES["train_4k"]
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (batch_rows or info["global_batch"],
                                       info["seq_len"] + 1))
    batch = {"tokens": torch.from_numpy(toks[:, :-1].astype(np.int32)),
             "labels": torch.from_numpy(toks[:, 1:].astype(np.int32))}
    args = cell.abstract_args(mesh)
    placed = [shr.place(x, common.arg_shardings(a))
              for x, a in zip((model, opt, batch), args)]
    return (model, opt, batch), placed


def _state_gap(a, b):
    """max |a - b| over ``{name: tensor}`` maps, and max |b|."""
    b = {n: t.detach().float() for n, t in b.items()}
    gap = max(float((a[n].float() - b[n]).abs().max()) for n in b)
    top = max(float(b[n].abs().max()) for n in b)
    return gap, top


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)], ids=["2x2", "4x1"])
def test_sharded_step_matches_unsharded(shape):
    """One step of qwen3's smoke train cell on a ``["cpu"] * 4`` mesh
    against the port's unsharded step on a copy: the loss within 1e-6
    relative, the gradients' global norm within 1e-5 relative, the
    weights, master copy and moments within 1e-5 x their max; every block
    of the new state has its spec's shape; two more steps run."""
    spec = TC.get_arch("qwen3-0.6b")
    cfg = spec.make_config(True)
    cell = spec.build_cell(cfg, "train_4k", smoke=True)
    mesh = M.make_mesh(shape, ("data", "model"), [CPU] * 4)
    (model, opt, batch), (pp, po, pb) = _train_state(cell, mesh)
    model, opt1, m1 = cell.fn(model, opt, batch)
    pp, po1, pm1 = cell.fn(pp, po, pb)
    ref_loss = float(m1["loss"])
    assert abs(float(pm1["loss"]) - ref_loss) <= 1e-6 * abs(ref_loss)
    # at step 1 AdamW's update does not see the gradient's scale (clipped,
    # then m / sqrt(v)): the norm does
    gn = float(m1["grad_norm"])
    assert abs(float(pm1["grad_norm"]) - gn) <= 1e-5 * gn
    got_p = shr.gather(pp)
    gap, top = _state_gap(got_p, dict(model.named_parameters()))
    assert gap <= 1e-5 * top, (gap, top)
    for field in ("master", "m", "v"):
        gap, top = _state_gap(shr.gather(getattr(po1, field)),
                              getattr(opt1, field))
        assert gap <= 1e-5 * top, (field, gap, top)
    assert po1.step == opt1.step == 1
    for name, x in {**pp, **po1.master}.items():
        want = x.sharding.block_shape(x.shape)
        assert all(tuple(b.shape) == want for b in x.blocks), name
    for _ in range(2):
        pp, po1, pm = cell.fn(pp, po1, pb)
        assert math.isfinite(float(pm["loss"]))
    assert po1.step == 3


def test_sharded_step_quantized_moments():
    """With int8 moments (DS-V3's ``OPT``) each leaf is updated whole on
    the first device and cut again: on a (2, 2) mesh of qwen3's smoke cell
    the loss within 1e-6 relative of the unsharded step's, the gradients'
    norm within 1e-5 relative, the weights and
    master copy within 1e-5 x their max, each moment's codes within one
    step and its scales within 1e-5 relative, the blocks of their specs'
    shapes."""
    spec = TC.get_arch("qwen3-0.6b")
    cfg = spec.make_config(True)
    opt_cfg = AdamWConfig(quantized_state=True)
    cell = build_lm_cell(cfg, "train_4k", opt_cfg, shapes=SMOKE_SHAPES)
    mesh = M.make_mesh((2, 2), ("data", "model"), [CPU] * 4)
    (model, opt, batch), (pp, po, pb) = _train_state(cell, mesh,
                                                     opt_cfg=opt_cfg)
    model, opt1, m1 = cell.fn(model, opt, batch)
    pp, po1, pm1 = cell.fn(pp, po, pb)
    assert abs(float(pm1["loss"]) - float(m1["loss"])) <= 1e-6 * abs(
        float(m1["loss"]))
    gn = float(m1["grad_norm"])
    assert abs(float(pm1["grad_norm"]) - gn) <= 1e-5 * gn
    gap, top = _state_gap(shr.gather(pp), dict(model.named_parameters()))
    assert gap <= 1e-5 * top
    gap, top = _state_gap(shr.gather(po1.master), opt1.master)
    assert gap <= 1e-5 * top
    for field in ("m", "v"):
        for name, want in getattr(opt1, field).items():
            got = {k: x.gather() for k, x in getattr(po1, field)[name].items()}
            assert (got["q"].int() - want["q"].int()).abs().max() <= 1
            torch.testing.assert_close(got["scale"], want["scale"],
                                       rtol=1e-5, atol=0)
            for k, x in getattr(po1, field)[name].items():
                assert all(tuple(b.shape) == x.sharding.block_shape(x.shape)
                           for b in x.blocks), (name, k)


def _step_against_unsharded(arch, shape=(2, 2), opt_cfg=AdamWConfig(),
                            cfg=None):
    """One step of ``arch``'s smoke train cell (of ``cfg`` if given) on a
    ``["cpu"] * 4`` mesh and the port's unsharded step on a copy: (the
    unsharded step's metrics, the mesh step's, the new weights, master
    copy and moments of each)."""
    cfg = cfg or TC.get_arch(arch).make_config(True)
    cell = build_lm_cell(cfg, "train_4k", opt_cfg, shapes=SMOKE_SHAPES)
    mesh = M.make_mesh(shape, ("data", "model"), [CPU] * 4)
    (model, opt, batch), (pp, po, pb) = _train_state(
        cell, mesh, arch=arch, opt_cfg=opt_cfg, cfg=cfg)
    model, opt1, m1 = cell.fn(model, opt, batch)
    pp, po1, pm1 = cell.fn(pp, po, pb)
    return m1, pm1, (dict(model.named_parameters()), opt1), (pp, po1)


def _assert_step_close(m1, pm1, ref, got):
    """The loss within 1e-6 relative, the gradients' norm within 1e-5
    relative, the weights, master copy and moments within 1e-5 x their
    max (qwen3's limits in ``test_sharded_step_matches_unsharded``)."""
    ref_loss = float(m1["loss"])
    assert abs(float(pm1["loss"]) - ref_loss) <= 1e-6 * abs(ref_loss), (
        float(pm1["loss"]), ref_loss)
    gn = float(m1["grad_norm"])
    assert abs(float(pm1["grad_norm"]) - gn) <= 1e-5 * gn, (
        float(pm1["grad_norm"]), gn)
    gap, top = _state_gap(shr.gather(got[0]), ref[0])
    assert gap <= 1e-5 * top, ("params", gap, top)
    for field in ("master", "m", "v"):
        gap, top = _state_gap(shr.gather(getattr(got[1], field)),
                              getattr(ref[1], field))
        assert gap <= 1e-5 * top, (field, gap, top)


def test_moe_mesh_step_routes_the_global_batch():
    """granite-moe's smoke train cell on a (2, 2) mesh against its
    unsharded step, at qwen3's limits: the MoE routes the global batch's
    tokens (its groups and capacity of the global token count, the aux
    loss over every token), so the mesh step is the unsharded step."""
    m1, pm1, ref, got = _step_against_unsharded("granite-moe-3b-a800m")
    _assert_step_close(m1, pm1, ref, got)


@pytest.mark.parametrize("arch,n_experts", [
    pytest.param("granite-20b", None, id="granite-20b"),
    pytest.param("deepseek-v3-671b", None, id="deepseek-v3-671b"),
    pytest.param("granite-moe-3b-a800m", 5, id="experts-by-width")])
def test_tensor_parallel_step_matches_unsharded(arch, n_experts):
    """The tensor-parallel step on a (2, 2) mesh against the unsharded
    step: granite-20b's MQA (one kv head, which two "model" shards read
    whole); DeepSeek-V3's MLA, shared experts, leading dense block and
    MTP head; granite-moe's smoke cell with 5 experts, a count that does
    not divide "model" = 2, so the expert stacks lie by width over
    "model" (as granite-moe's 40 experts on JAX's (16, 16) mesh) and each
    shard runs its columns of every expert, column- then row-parallel."""
    import dataclasses

    from repro_torch.distributed import tensor_parallel as tp

    cfg = TC.get_arch(arch).make_config(True)
    if n_experts:
        cfg = dataclasses.replace(cfg, n_experts=n_experts)
        cell = build_lm_cell(cfg, "train_4k", AdamWConfig(),
                             shapes=SMOKE_SHAPES)
        mesh = M.make_mesh((2, 2), ("data", "model"), [CPU] * 4)
        _, (pp, _, _) = _train_state(cell, mesh, cfg=cfg)
        sh = tp.Shards(mesh, pp)
        stacks = {n: sh.split_dim(n) for n in pp
                  if n.split(".")[-2:-1] == ["moe"] and n.endswith(
                      ("w_gate", "w_up", "w_down"))}
        assert stacks and all(
            d == (1 if n.endswith("w_down") else 2)
            for n, d in stacks.items()), stacks
    _assert_step_close(*_step_against_unsharded(arch, cfg=cfg))


def test_moe_groups_straddling_rows_raise():
    """A data row must hold whole routing groups of the global batch: 2
    rows of 7 tokens form one group of 14 (14 is no multiple of the 32
    groups), which straddles them, so the step raises, naming the
    shapes; the layout rule itself at the smoke cell's and full size's
    shapes."""
    from repro_torch.models import moe

    spec = TC.get_arch("granite-moe-3b-a800m")
    cfg = spec.make_config(True)
    mc = cfg.moe_cfg()
    assert moe.row_layout(mc, 4 * 64, 2) == (16, moe.capacity(mc, 8))
    full = spec.make_config(False).moe_cfg()
    assert moe.row_layout(full, 2 * 4096, 2) == (16, 64)
    assert moe.row_layout(full, 256 * 4096, 16) == (2, moe.capacity(
        full, 256 * 4096 // 32))
    with pytest.raises(ValueError, match="1 groups of 14 tokens"):
        moe.row_layout(mc, 14, 2)
    cell = spec.build_cell(cfg, "train_4k", smoke=True)
    mesh = M.make_mesh((2, 2), ("data", "model"), [CPU] * 4)
    _, (pp, po, pb) = _train_state(cell, mesh,
                                   arch="granite-moe-3b-a800m")
    short = {k: shr.Placed(shr.shard_tensor(x.gather()[:2, :7].contiguous(),
                                            x.sharding), x.sharding)
             for k, x in pb.items()}
    with pytest.raises(ValueError, match="do not split over 2 data rows"):
        cell.fn(pp, po, short)


def test_vocab_parallel_cross_entropy_matches_chunked():
    """The tied head's cross entropy with the vocab over "model" (two
    shards' log-sum-exps, the label's logit from its owner), in chunks of
    16 and a remainder of 8, against ``transformer.chunked_cross_entropy``
    on the whole table: the value within 1e-6 relative, the gradients of
    the hidden states and of every block of the table within 1e-5 x their
    max."""
    from types import SimpleNamespace

    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.models import transformer as T

    g = torch.Generator().manual_seed(3)
    vocab, d, b, s = 96, 12, 2, 40
    table = torch.randn(vocab, d, generator=g) * 0.5
    hidden = torch.randn(b, s, d, generator=g).requires_grad_()
    labels = torch.randint(0, vocab, (b, s), generator=g, dtype=torch.int32)
    mesh = M.make_mesh((2, 2), ("data", "model"), [CPU] * 4)
    sh = shr.NamedSharding(mesh, shr.P("model", "data"))
    shards = tp.Shards(mesh, {"embed": shr.Placed(shr.shard_tensor(table, sh),
                                                  sh)})
    row = tp.Row(mesh, (0, 0), {}, b)
    got = tp.cross_entropy(shards, SimpleNamespace(ce_chunk=16), hidden,
                           labels, row, chunked=True)
    leaves = [leaf for _, _, leaf in shards.leaves["embed"]]
    g_got = torch.autograd.grad(got, [hidden, *leaves])
    whole = table.clone().requires_grad_()
    want = T.chunked_cross_entropy(hidden, whole, labels, 16)
    g_want = torch.autograd.grad(want, [hidden, whole])
    assert abs(float(got.detach()) - float(want.detach())) <= 1e-6 * abs(
        float(want.detach()))
    top = float(g_want[0].abs().max())
    assert float((g_got[0] - g_want[0]).abs().max()) <= 1e-5 * top
    grad_table = shr.gather_tensor(
        shards.grads({"embed": list(g_got[1:])})["embed"], sh)
    top = float(g_want[1].abs().max())
    assert float((grad_table - g_want[1]).abs().max()) <= 1e-5 * top


def test_step_on_placed_args_needs_abstract_args():
    """The step learns its mesh from ``abstract_args(mesh)``: placed
    arguments before it raise."""
    spec = TC.get_arch("qwen3-0.6b")
    cfg = spec.make_config(True)
    mesh = M.make_mesh((2, 2), ("data", "model"), [CPU] * 4)
    _, placed = _train_state(spec.build_cell(cfg, "train_4k", smoke=True),
                             mesh)
    fresh = spec.build_cell(cfg, "train_4k", smoke=True)
    with pytest.raises(ValueError, match="abstract_args"):
        fresh.fn(*placed)


def test_mesh_constructors():
    """``make_mesh`` over given devices, row-major; a mesh of mixed device
    types raises; ``make_host_mesh`` clamps as JAX's does and builds on the
    CPU when asked; the production meshes need 256 / 512 devices; an
    abstract mesh gives specs and refuses placement."""
    m = M.make_mesh((2, 3), ("data", "model"), [CPU] * 6)
    assert m.shape == {"data": 2, "model": 3} and m.size == 6
    assert M.axis_size(m, "model") == 3
    assert m.positions()[:4] == [(0, 0), (0, 1), (0, 2), (1, 0)]
    with pytest.raises(ValueError, match="mix types"):
        M.make_mesh((2,), ("data",), [CPU, "cuda:0"])
    with pytest.raises(ValueError, match="needs 4 devices"):
        M.make_mesh((2, 2), ("data", "model"), [CPU] * 3)
    h = M.make_host_mesh(device=CPU)
    assert h.shape == {"data": 1, "model": 1}
    h = M.make_host_mesh(2, 4, devices=[CPU] * 6)
    assert h.shape == {"data": 1, "model": 4}
    h = M.make_host_mesh(2, 2, devices=[CPU] * 8)
    assert h.shape == {"data": 2, "model": 2}
    for multi, n in ((False, 256), (True, 512)):
        with pytest.raises(ValueError, match=f"needs {n} devices"):
            M.make_production_mesh(multi_pod=multi, devices=[CPU] * 8)
        assert M.make_production_mesh(
            multi_pod=multi, devices=[CPU] * n).size == n
    abstract = M.Mesh((16, 16), ("data", "model"))
    with pytest.raises(ValueError, match="abstract"):
        shr.shard_tensor(torch.zeros(16), shr.NamedSharding(abstract,
                                                            shr.P("data")))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            M.make_host_mesh()


def _qpsum_bound(trees, name):
    """Each element's limit S · scale / 2: ``scale`` its block's absmax over
    the shards, / 127."""
    gs = [t[name].float() for t in trees]
    d = gs[0].shape[-1]
    pad = (-d) % compression.QBLOCK
    blocks = [torch.nn.functional.pad(g, (0, pad)).reshape(
        *g.shape[:-1], -1, compression.QBLOCK) for g in gs]
    scale = torch.stack([b.abs().amax(-1) / 127.0 for b in blocks]).amax(0)
    per = scale.repeat_interleave(compression.QBLOCK, -1)[..., :d]
    return len(gs) * per / 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantized_psum_within_bound(dtype):
    """Over 4 shards, on a leaf whose last dimension (300) is no multiple
    of 128 and a 3-D one: every element within S · scale / 2 of the exact
    f32 sum (plus the bf16 rounding of the output), every shard's copy
    equal, and a second call bit-equal."""
    g = torch.Generator().manual_seed(0)
    trees = [{"a": torch.randn(5, 300, generator=g).to(dtype),
              "b": torch.randn(2, 3, 256, generator=g).to(dtype)}
             for _ in range(4)]
    out = compression.quantized_psum(trees)
    again = compression.quantized_psum(trees)
    for name in ("a", "b"):
        exact = sum(t[name].float() for t in trees)
        lim = _qpsum_bound(trees, name)
        if dtype == torch.bfloat16:
            lim = lim + exact.abs() * 2.0 ** -8 + lim * 2.0 ** -8
        err = (out[0][name].float() - exact).abs()
        assert bool((err <= lim).all()), float((err - lim).max())
        assert out[0][name].dtype == dtype
        for o, a in zip(out, again):
            assert torch.equal(o[name], out[0][name])
            assert torch.equal(a[name], o[name])
        rel = float(err.max() / exact.abs().max())
        assert rel < 0.05, rel
