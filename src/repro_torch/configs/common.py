"""Shared machinery for architecture configs: cells, step builders, specs;
the counterpart of ``repro.configs.common``.

An *arch* module exposes ``SPEC: ArchSpec``. Each of its shapes defines one
**cell**: a step function plus allocation-free abstract arguments and, on a
mesh, their shardings.

PyTorch idiom: JAX's ``ShapeDtypeStruct`` is a tensor on the ``meta``
device (shape and dtype, no storage), and ``jax.eval_shape`` of an
initialiser is the model's module built on ``meta``, its draws skipped
(:func:`abstract_params`). ``abstract_args()`` with no mesh gives those;
``abstract_args(mesh)`` gives each leaf with its ``NamedSharding`` in the
attribute ``sharding`` (:func:`sds`, :func:`with_shardings`), the weights as
a ``{name: leaf}`` map. ``distributed.sharding.place`` lays concrete tensors
out by those shardings, and the train cell's ``fn`` runs on what it laid
out (:func:`make_train_step`). ``donate`` has no counterpart: the step
writes the new weights into its argument in place.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable

import torch
from torch import nn

from repro_torch.distributed.sharding import (NamedSharding, Placed,
                                              gather_tensor, shard_tensor,
                                              tree_map)
from repro_torch.train.optimizer import (AdamWConfig, AdamWState, adamw_leaf,
                                         adamw_scalars, make_adamw, named)

META = torch.device("meta")


def sds(shape, dtype, mesh=None, spec=None) -> torch.Tensor:
    """A tensor of ``shape`` and ``dtype`` with no storage (JAX's
    ``ShapeDtypeStruct``); with ``mesh`` and ``spec`` it carries
    ``NamedSharding(mesh, spec)`` as ``.sharding``."""
    t = torch.empty(shape, dtype=dtype, device=META)
    if mesh is not None and spec is not None:
        t.sharding = NamedSharding(mesh, spec)
    return t


def with_shardings(abstract, specs, mesh):
    """The abstract leaves of ``abstract`` (a meta module reads as its
    parameters) with shardings attached, leaf by leaf from ``specs``."""
    if isinstance(abstract, nn.Module):
        abstract = named(abstract)

    def one(a, s):
        if not isinstance(a, torch.Tensor):
            return a  # AdamWState.step, an int
        return sds(a.shape, a.dtype, mesh, s)

    return tree_map(one, abstract, specs)


def arg_shardings(tree):
    """The sharding of each abstract leaf (None where it has none)."""
    if isinstance(tree, nn.Module):
        tree = named(tree)
    return tree_map(lambda a: getattr(a, "sharding", None), tree)


@dataclasses.dataclass
class CellSpec:
    """One (arch × shape) target."""

    name: str  # f"{arch}/{shape}"
    entry: str  # train | prefill | decode | serve | retrieval
    fn: Callable  # the step
    # (mesh=None) -> args of meta tensors (without a mesh a module on meta
    # for the weights; on a mesh every leaf with its sharding)
    abstract_args: Callable[..., tuple]
    # batch-like dims for MODEL_FLOPS accounting
    tokens: int = 0  # tokens processed per step (LM) / items scored (recsys)
    # mesh axes of the activations' batch ("dp" = pod+data, "all" =
    # pod+data+model: the GNN's nodes and edges)
    act_axes: str = "dp"
    # abstract args -> the outputs' shardings (None entries: as they come)
    out_shardings: Any = None


@dataclasses.dataclass
class ArchSpec:
    name: str
    family: str  # lm | gnn | recsys
    make_config: Callable[[bool], Any]  # smoke -> config
    shapes: dict[str, dict]  # shape name -> shape kwargs
    # (config, shape, smoke=False) -> cell; ``smoke`` picks the shape table
    build_cell: Callable[..., CellSpec]
    # (seed or generator, config, device=None) -> the model with its weights
    init_params: Callable[..., nn.Module]
    # (config, device) -> the model's module, weights not drawn
    model: Callable[[Any, Any], nn.Module]

    def cells(self, smoke: bool = False):
        cfg = self.make_config(smoke)
        return {s: self.build_cell(cfg, s, smoke=smoke) for s in self.shapes}


def count_params(abstract) -> int:
    """Elements of a module's parameters or of a ``{name: tensor}`` map."""
    return sum(t.numel() for t in named(abstract).values())


def abstract_params(model_fn: Callable[[Any, Any], nn.Module],
                    cfg) -> nn.Module:
    """``model_fn(cfg, device)`` built on the meta device: every parameter's
    shape and dtype, nothing allocated or drawn (JAX's ``eval_shape`` of
    ``init_params``)."""
    return model_fn(cfg, META)


def make_train_step(loss_fn: Callable, opt_cfg: AdamWConfig,
                    grad_specs_holder: dict | None = None):
    """A fused forward, backward and AdamW step: ``(params, opt_state,
    batch) -> (params, opt_state, metrics)``.

    ``params`` is a module (or a ``{name: tensor}`` map of leaves that
    require grad); ``loss_fn(params, batch) -> (loss, metrics)``. The new
    weights are written into ``params`` in place, which is returned, as a
    donated buffer would be; ``opt_state`` is replaced. A parameter the
    loss does not reach (the GAT's bias) gets a zero gradient, as under
    ``jax.grad``.

    On a mesh the arguments are laid out by the cell's
    ``abstract_args(mesh)`` (``sharding.place``), which fills
    ``grad_specs_holder`` with the mesh, the optimizer's specs (``specs``)
    and the model's module on the meta device (``model``); an LM cell also
    leaves ``blocks_loss`` there (``tensor_parallel.lm_loss_and_grads``):
    the forward and one backward run on the weights' blocks themselves,
    each data row's layers on its "model" shards, every row and shard of a
    layer before the next, and the gradients arrive in the blocks' layout.
    Without it (the recommenders) each data row's rows of the batch run on
    that row's first device through a copy of the model gathered from the
    weights' blocks, and the gradients are summed over the rows in row
    order, weighted by their share of the batch (each loss is a mean with
    a fixed count a row), in f32, then cast to the parameter's dtype. Either
    way the gradients are cut to the optimizer's layout where it differs,
    AdamW runs on each block, the global norm summed over the blocks (each
    element once), and the new weights are written back into their blocks.
    """
    _, opt_update = make_adamw(opt_cfg)

    def train_step(params, opt_state, batch):
        leaves = named(params)
        if any(isinstance(p, Placed) for p in leaves.values()):
            return _mesh_step(loss_fn, opt_cfg, grad_specs_holder or {},
                              leaves, opt_state, batch)
        loss, metrics = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g
                 for (n, p), g in zip(leaves.items(), grads)}
        new, opt_state, stats = opt_update(grads, opt_state, leaves)
        with torch.no_grad():
            for n, p in leaves.items():
                p.copy_(new[n])
        return params, opt_state, {"loss": loss.detach(), **stats}

    return train_step


def _row_groups(batch: dict, mesh):
    """``[(position, {key: rows}, n_rows)]``: the placed batch's row blocks
    along its first dimension, each once, in row order, at the first
    position that holds it."""
    first = next(iter(batch.values()))
    if not isinstance(first, Placed):
        raise ValueError("a step on placed weights takes a placed batch")
    groups, seen = [], set()
    for i, pos in enumerate(mesh.positions()):
        rows = first.sharding.block_slices(first.shape, pos)[0]
        if (rows.start, rows.stop) in seen:
            continue
        seen.add((rows.start, rows.stop))
        for x in batch.values():
            if x.sharding.block_slices(x.shape, pos)[0] != rows:
                raise ValueError("the batch's leaves split their rows "
                                 "differently")
        groups.append((pos, {k: x.blocks[i] for k, x in batch.items()},
                       rows.stop - rows.start))
    return groups


def _replica_grads(loss_fn, template, params, groups, mesh):
    """(loss, whole gradients, {}) of the rows run one after the other,
    each through a copy of the model gathered from the blocks."""
    total = sum(n for _, _, n in groups)
    dev0 = mesh.device_at(groups[0][0])
    row_grads, loss = [], torch.zeros((), device=dev0)
    for pos, rows, n in groups:
        replica = copy.deepcopy(template).to_empty(device=mesh.device_at(pos))
        weights = named(replica)
        with torch.no_grad():
            for name, w in weights.items():
                gather_tensor(params[name].blocks, params[name].sharding,
                              out=w)
        lo, _ = loss_fn(replica, rows)
        gs = torch.autograd.grad(lo, list(weights.values()),
                                 allow_unused=True)
        row_grads.append((n / total, [torch.zeros_like(w) if g is None
                                      else g for w, g in zip(
                                          weights.values(), gs)]))
        loss = loss + (n / total) * lo.detach().float().to(dev0)
        del replica, weights, gs, lo
    # the rows' gradients summed in row order, in f32, cast to the
    # parameter's dtype
    grads = {}
    for i, name in enumerate(params):
        acc = None
        for w, gs in row_grads:
            term = w * gs[i].float().to(dev0)
            acc = term if acc is None else acc + term
            gs[i] = None
        grads[name] = acc.to(params[name].dtype)
    return loss, grads, {}


def _mesh_step(loss_fn, opt_cfg, holder, params, opt_state, batch):
    """:func:`make_train_step` on placed arguments (see there)."""
    if holder.get("mesh") is None:
        raise ValueError(
            "a step on placed arguments needs the cell's abstract_args(mesh) "
            "first: it fills the step's grad_specs_holder")
    mesh, specs, template = holder["mesh"], holder["specs"], holder["model"]
    groups = _row_groups(batch, mesh)
    dev0 = mesh.device_at(groups[0][0])
    blocks_loss = holder.get("blocks_loss")
    if blocks_loss is not None:
        loss, by_block, extra = blocks_loss(template, params, groups, mesh)
    else:
        loss, whole, extra = _replica_grads(loss_fn, template, params,
                                            groups, mesh)
    # cut to the optimizer's layout
    grads = {}
    for name, p in params.items():
        sh = NamedSharding(mesh, specs[name])
        if sh != opt_state.master[name].sharding:
            raise ValueError(f"{name}: the gradients' layout {specs[name]} "
                             "is not the optimizer's")
        if blocks_loss is None:
            grads[name] = shard_tensor(whole.pop(name), sh)
        elif p.sharding == sh:
            grads[name] = by_block.pop(name)
        else:
            grads[name] = shard_tensor(
                gather_tensor(by_block.pop(name), p.sharding), sh)
    sq = torch.zeros((), device=dev0)
    for name, blocks in grads.items():
        for pos, g in zip(mesh.positions(), blocks):
            if opt_state.master[name].sharding.replica_id(pos) == 0:
                sq = sq + (g.float() ** 2).sum().to(dev0)
    gn = torch.sqrt(sq)
    step = opt_state.step + 1
    sc = adamw_scalars(opt_cfg, step, gn)
    master, m, v = {}, {}, {}
    for name, p in params.items():
        ms = opt_state.master[name]
        decay = len(ms.shape) >= 2
        if opt_cfg.quantized_state:
            # a quantized moment's scales span the whole last axis: the
            # leaf is updated whole on the first device, then cut again
            mm, vv = ({k: x.gather() for k, x in t[name].items()}
                      for t in (opt_state.m, opt_state.v))
            full = adamw_leaf(opt_cfg,
                              gather_tensor(grads[name], ms.sharding),
                              ms.gather(), mm, vv, sc, decay)
            master[name] = Placed(shard_tensor(full[0], ms.sharding),
                                  ms.sharding)
            for tree, old, new in ((m, opt_state.m, full[1]),
                                   (v, opt_state.v, full[2])):
                tree[name] = {k: Placed(shard_tensor(new[k], x.sharding),
                                        x.sharding)
                              for k, x in old[name].items()}
        else:
            outs = [adamw_leaf(opt_cfg, g, mb, mm, vv, sc, decay)
                    for g, mb, mm, vv in zip(
                        grads[name], ms.blocks, opt_state.m[name].blocks,
                        opt_state.v[name].blocks)]
            for tree, k in ((master, 0), (m, 1), (v, 2)):
                tree[name] = Placed(tuple(o[k] for o in outs), ms.sharding)
        _write_weights(p, master[name])
    return (params, AdamWState(step=step, master=master, m=m, v=v),
            {**extra, "loss": loss, "grad_norm": gn, "lr": sc.lr})


@torch.no_grad()
def _write_weights(p: Placed, master: Placed) -> None:
    """The new master copy, cast, into the weight's blocks in place."""
    if p.sharding == master.sharding:
        for blk, mb in zip(p.blocks, master.blocks):
            blk.copy_(mb)
        return
    full = master.gather()
    for pos, blk in zip(p.sharding.mesh.positions(), p.blocks):
        blk.copy_(full[p.sharding.block_slices(full.shape, pos)])


def abstract_opt_state(opt_cfg: AdamWConfig, params_abs):
    """AdamW's state of ``params_abs`` (on the meta device) on the meta
    device."""
    opt_init, _ = make_adamw(opt_cfg)
    return opt_init(params_abs)
