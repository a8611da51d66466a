"""gat-cora [arXiv:1710.10903]: 2 layers, d_hidden 8, 8 heads, attention
aggregator; JAX's ``repro.configs.gat_cora`` tables.

Four graph regimes (padded to 512-divisible sizes; padding edges are -1 and
padded nodes are masked):

  full_graph_sm — Cora: 2,708 nodes / 10,556 edges / 1,433 feats (pad 3072/10752)
  minibatch_lg  — Reddit-scale sampled block: 1,024 seeds × fanout 15·10
                  -> 169,984-node block (exactly 512-divisible), 602 feats
  ogb_products  — 2,449,029 nodes / 61,859,140 edges / 100 feats
                  (pad 2,449,408 / 61,859,840)
  molecule      — 128 disjoint graphs × 30 nodes / 64 edges, graph-level
                  classification via segment-mean readout (pad N to 4096)

:func:`build_gnn_cell` makes a shape's train cell: one full-batch forward,
backward and AdamW step of :func:`graph_loss` (on one card; JAX shards the
nodes and edges over every mesh axis). :func:`full` / :func:`smoke` give
the ``GATConfig`` it makes for a shape, and ``OPT`` its optimizer."""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.configs import common
from repro_torch.distributed import sharding as shr
from repro_torch.models import gnn
from repro_torch.train.optimizer import AdamWConfig

GNN_SHAPES = {
    "full_graph_sm": dict(n_nodes=3072, n_edges=10752, d_feat=1433,
                          n_classes=7, task="node",
                          true_nodes=2708, true_edges=10556),
    "minibatch_lg": dict(n_nodes=169984, n_edges=169984, d_feat=602,
                         n_classes=41, task="node",
                         true_nodes=232965, true_edges=114615892),
    "ogb_products": dict(n_nodes=2449408, n_edges=61859840, d_feat=100,
                         n_classes=47, task="node",
                         true_nodes=2449029, true_edges=61859140),
    "molecule": dict(n_nodes=4096, n_edges=8192, d_feat=16, n_classes=2,
                     task="graph", n_graphs=128,
                     true_nodes=3840, true_edges=8192),
}

SMOKE_SHAPES = {
    k: dict(v, n_nodes=min(v["n_nodes"], 256), n_edges=min(v["n_edges"], 512),
            d_feat=min(v["d_feat"], 32),
            n_graphs=min(v.get("n_graphs", 0), 8) or v.get("n_graphs"))
    for k, v in GNN_SHAPES.items()
}

#: the cells' optimizer: AdamW without weight decay
OPT = AdamWConfig(weight_decay=0.0)


def graph_loss(model: gnn.GAT, batch: dict, *, task: str, n_graphs: int = 0,
               chunk: int | None = None):
    """``task="node"``: ``gnn.loss_fn``. ``task="graph"``: per-node logits,
    a mean over each graph's nodes (graph ids outside [0, n_graphs) are
    dropped, as JAX's ``segment_sum`` drops them), cross entropy against
    ``graph_labels``. The readout is a one-hot (n_graphs, N) product: no
    atomic adds, so the card gives one answer."""
    if task == "node":
        return gnn.loss_fn(model, batch, chunk=chunk)
    logits = gnn.forward(model, batch["feats"], batch["src"], batch["dst"],
                         chunk=chunk)
    gid = batch["graph_ids"]
    onehot = (gid[None, :] == torch.arange(n_graphs, device=gid.device,
                                           dtype=gid.dtype)[:, None]).float()
    g = (onehot @ logits.float()) / onehot.sum(1).clamp(min=1.0)[:, None]
    labels = batch["graph_labels"].long()
    loss = (torch.logsumexp(g, dim=-1)
            - g.gather(-1, labels[:, None])[:, 0]).mean()
    return loss, {"loss": loss}


def _config(info: dict) -> gnn.GATConfig:
    return gnn.GATConfig(name="gat", n_layers=2, d_hidden=8, n_heads=8,
                         d_in=info["d_feat"], n_classes=info["n_classes"])


def full(shape: str) -> gnn.GATConfig:
    return _config(GNN_SHAPES[shape])


def smoke(shape: str) -> gnn.GATConfig:
    return _config(SMOKE_SHAPES[shape])


def build_gnn_cell(cfg_dummy, shape_name: str, *, smoke: bool = False,
                   opt_cfg: AdamWConfig | None = None) -> common.CellSpec:
    """The shape's train cell: ``fn(model, opt_state, batch)``, one step of
    :func:`graph_loss` under AdamW (``OPT`` unless ``opt_cfg``); the
    abstract batch is JAX's (feats f32 (N, F), src/dst int32 (E,), labels
    int32 and mask f32 (N,); the graph task's graph_ids (N,) and
    graph_labels (n_graphs,) in place of labels and mask)."""
    info = (SMOKE_SHAPES if smoke else GNN_SHAPES)[shape_name]
    opt_cfg = opt_cfg or OPT
    cfg = _config(info)
    task = info["task"]
    n_graphs = info.get("n_graphs") or 0
    loss = functools.partial(graph_loss, task=task, n_graphs=n_graphs)

    def abstract_args(mesh=None):
        """Without a mesh: meta tensors. On a mesh, JAX's specs: the
        weights replicated, the nodes and edges over every axis where they
        divide, the graph labels replicated."""
        p_abs = common.abstract_params(gnn.GAT, cfg)
        o_abs = common.abstract_opt_state(opt_cfg, p_abs)
        n, e = info["n_nodes"], info["n_edges"]
        nd = ed = None  # the node and edge dimensions' axes
        if mesh is not None:
            ax = shr.all_axes(mesh)
            nd = ax if n % _axprod(mesh, ax) == 0 else None
            ed = ax if e % _axprod(mesh, ax) == 0 else None
        sds = functools.partial(common.sds, mesh=mesh)
        b = {"feats": sds((n, info["d_feat"]), torch.float32,
                          spec=shr.P(nd, None)),
             "src": sds((e,), torch.int32, spec=shr.P(ed)),
             "dst": sds((e,), torch.int32, spec=shr.P(ed))}
        if task == "graph":
            b["graph_ids"] = sds((n,), torch.int32, spec=shr.P(nd))
            b["graph_labels"] = sds((n_graphs,), torch.int32, spec=shr.P())
        else:
            b["labels"] = sds((n,), torch.int32, spec=shr.P(nd))
            b["mask"] = sds((n,), torch.float32, spec=shr.P(nd))
        if mesh is None:
            return p_abs, o_abs, b
        p_specs = shr.replicated_specs(p_abs)
        o_specs = shr.opt_state_specs(p_specs, o_abs, p_abs)
        return (common.with_shardings(p_abs, p_specs, mesh),
                common.with_shardings(o_abs, o_specs, mesh), b)

    return common.CellSpec(
        name=f"gat-cora/{shape_name}", entry="train",
        fn=common.make_train_step(loss, opt_cfg),
        abstract_args=abstract_args, tokens=info["n_nodes"], act_axes="all",
        out_shardings=lambda args: (common.arg_shardings(args[0]),
                                    common.arg_shardings(args[1]), None))


def _axprod(mesh, axes) -> int:
    return math.prod(mesh.shape[a] for a in axes)


SPEC = common.ArchSpec(
    name="gat-cora",
    family="gnn",
    make_config=lambda smoke=False: gnn.GATConfig(),
    shapes=GNN_SHAPES,
    build_cell=build_gnn_cell,
    init_params=gnn.init_params,
    model=gnn.GAT,
)
