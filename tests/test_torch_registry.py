"""The port's arch registry (``repro_torch.configs``: ``ARCHS``,
``get_arch``, ``all_cells``, each config's ``SPEC``, ``common``,
``lm_common``, ``recsys_common``, ``gat_cora.build_gnn_cell``) against
``repro.configs``, and the training launcher on it.

* the ten archs and the extra one, their shape tables and families, and
  the 40 cells are JAX's;
* each arch's parameters at its **full** size, counted on the meta device,
  are JAX's, counted over ``jax.eval_shape`` of its ``init_params``;
* every smoke cell's abstract arguments have JAX's shapes and dtypes (on a
  (1, 1) host mesh for JAX), and its ``fn`` runs once on the CPU on inputs
  made from them, with finite outputs;
* ``launch/train.py`` trains granite-20b's smoke config and refuses both
  dense LMs' full configs by their training state, before drawing a weight.
"""
import collections
import math

import jax
import numpy as np
import pytest
import torch
from torch import nn

from repro import configs as JC
from repro.configs import gat_cora as jgat
from repro.launch.mesh import make_mesh
from repro_torch import configs as TC
from repro_torch.configs import common
from repro_torch.configs import gat_cora as tgat
from repro_torch.models import transformer as TT

CPU = "cpu"
NAMES = [*JC.ARCHS, *JC.EXTRA_ARCHS]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The smoke cells are tiny: torch's intra-op threads cost more than
    they save when the suite runs its files side by side. Restored after
    the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh((1, 1), ("data", "model"))


def _smoke_cells(mod, name):
    """{shape: cell} of ``name``'s smoke config in registry ``mod`` (the
    GAT's through ``build_gnn_cell(..., smoke=True)``, as JAX's
    ``tests/test_arch_smoke.py`` builds them)."""
    spec = mod.get_arch(name)
    if name == "gat-cora":
        gat = jgat if mod is JC else tgat
        return {s: gat.build_gnn_cell(None, s, smoke=True)
                for s in spec.shapes}
    return spec.cells(smoke=True)


def _census(leaves) -> collections.Counter:
    """Elements by dtype name over shaped leaves."""
    out = collections.Counter()
    for x in leaves:
        out[str(x.dtype).split(".")[-1]] += math.prod(x.shape)
    return out


def _port_leaves(x):
    if isinstance(x, nn.Module):
        return list(x.parameters())
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):  # in key order, as JAX flattens a dict
        return [y for k in sorted(x) for y in _port_leaves(x[k])]
    if isinstance(x, (tuple, list)):
        return [y for v in x for y in _port_leaves(v)]
    return []  # AdamWState.step, an int


def _same_arrays(got, want, what):
    """Meta tensors against ShapeDtypeStructs, a leaf each, in order."""
    got, want = _port_leaves(got), jax.tree.leaves(want)
    assert [(tuple(g.shape), str(g.dtype).split(".")[-1]) for g in got] == [
        (tuple(w.shape), str(w.dtype)) for w in want], what
    assert all(g.device.type == "meta" for g in got), what


def _concrete(x, g):
    """A value of ``x``'s structure on the CPU: a meta module's parameters
    normal x 0.02, float tensors uniform in [0, 1), integer tensors in
    {0, 1} (a valid id, label, node, position or length of every cell)."""
    if isinstance(x, nn.Module):
        x.to_empty(device=CPU)
        with torch.no_grad():
            for p in x.parameters():
                p.normal_(0.0, 0.02, generator=g)
        return x
    if isinstance(x, torch.Tensor):
        if x.dtype.is_floating_point:
            return torch.rand(x.shape, generator=g).to(x.dtype)
        return torch.randint(0, 2, x.shape, generator=g, dtype=x.dtype)
    if isinstance(x, dict):
        return {k: _concrete(v, g) for k, v in x.items()}
    if isinstance(x, tuple):
        vals = [_concrete(v, g) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    return x


def test_registry_holds_jaxs_archs_and_cells():
    assert len(TC.ARCHS) == 10 and list(TC.ARCHS) == list(JC.ARCHS)
    assert list(TC.EXTRA_ARCHS) == list(JC.EXTRA_ARCHS) == ["sfr-mistral-7b"]
    assert len(TC.all_cells()) == 40 and TC.all_cells() == JC.all_cells()
    for name in NAMES:
        assert TC.get_arch(name).name == name
    with pytest.raises(KeyError, match="unknown arch"):
        TC.get_arch("gpt-5")


@pytest.mark.parametrize("name", NAMES)
def test_spec_shapes_and_family_are_jaxs(name):
    got, want = TC.get_arch(name), JC.get_arch(name)
    assert got.family == want.family
    assert got.shapes == want.shapes
    assert list(got.shapes) == list(want.shapes)


@pytest.mark.parametrize("name", NAMES)
def test_full_size_parameter_count_is_jaxs(name):
    """On the meta device and under ``jax.eval_shape``, nothing allocated.
    JAX's leaves are counted as Python ints: its ``count_params`` folds the
    product in int32, which wraps past 2^31 (granite-20b reads
    2,101,991,424 there)."""
    spec, jspec = TC.get_arch(name), JC.get_arch(name)
    got = common.count_params(common.abstract_params(
        spec.model, spec.make_config(False)))
    want = sum(math.prod(x.shape) for x in jax.tree.leaves(
        jax.eval_shape(lambda k: jspec.init_params(k, jspec.make_config(
            False)), jax.random.PRNGKey(0))))
    assert got == want
    if name == "granite-20b":
        assert got == 27_871_795_200
    if name == "deepseek-coder-33b":
        assert got == 33_126_460_416


@pytest.mark.parametrize("name", list(JC.ARCHS))
def test_smoke_cells_have_jaxs_args_and_run(name, mesh):
    """Each of the arch's four smoke cells: JAX's name, entry and token
    count; its abstract arguments JAX's shapes and dtypes (the weights and
    the optimizer's state as elements by dtype: JAX stacks an LM's layers
    and the port holds one tensor a layer); ``fn`` once on the CPU."""
    got, want = _smoke_cells(TC, name), _smoke_cells(JC, name)
    assert list(got) == list(want)
    g = torch.Generator().manual_seed(0)
    for shape, cell in got.items():
        jcell = want[shape]
        assert (cell.name, cell.entry, cell.tokens) == (
            jcell.name, jcell.entry, jcell.tokens)
        args, jargs = cell.abstract_args(), jcell.abstract_args(mesh)
        assert len(args) == len(jargs)
        assert _census(_port_leaves(args[0])) == _census(
            jax.tree.leaves(jargs[0])), shape
        if cell.entry == "train":
            opt, jopt = args[1], jargs[1]
            assert _census(_port_leaves([opt.master, opt.m, opt.v])) == \
                _census(jax.tree.leaves([jopt.master, jopt.m, jopt.v]))
            _same_arrays(args[2], jargs[2], shape)
        else:
            _same_arrays(args[1:], jargs[1:], shape)
        out = cell.fn(*_concrete(args, g))
        leaves = [x for x in _port_leaves(out) if x.dtype.is_floating_point]
        assert leaves and all(bool(torch.isfinite(x).all()) for x in leaves)
        if cell.entry == "train":
            assert out[1].step == 1 and math.isfinite(float(out[2]["loss"]))


@pytest.mark.parametrize("arch", ["granite-20b", "deepseek-coder-33b"])
def test_launcher_trains_smoke_and_refuses_full(arch, monkeypatch, capsys):
    """``--preset smoke`` trains on the CPU; ``--preset full`` is refused
    by its training state (bf16 weights and gradients, the f32 master copy
    and moments: 16 bytes a parameter, ≈ 446 GB and ≈ 530 GB) before a
    weight is drawn."""
    from repro_torch.launch import train as launch_train
    from repro_torch.train.optimizer import AdamWConfig

    if arch == "granite-20b":
        trainer, out = launch_train.main(["--arch", arch, "--steps", "3",
                                          "--batch", "2", "--seq", "16",
                                          "--device", CPU])
        assert trainer.step == 3 and all(np.isfinite(out["losses"]))
        assert f"arch={arch} preset=smoke" in capsys.readouterr().out

    def never(*a, **k):
        raise AssertionError("a weight was drawn")

    monkeypatch.setattr(TT, "init_params", never)
    with pytest.raises(ValueError, match="bytes"):
        launch_train.main(["--arch", arch, "--preset", "full",
                           "--device", CPU])
    need = launch_train.train_state_bytes(TC.get_arch(arch).make_config(
        False), AdamWConfig())
    assert need == 16 * common.count_params(common.abstract_params(
        TT.Transformer, TC.get_arch(arch).make_config(False)))
