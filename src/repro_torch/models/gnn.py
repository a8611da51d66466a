"""GAT (Veličković et al., arXiv:1710.10903), the counterpart of
``repro.models.gnn``: SDDMM-style edge scores from gathered endpoints, a
segment softmax over each node's incoming edges, then a segment sum of the
messages.

JAX's function, exactly: only ``src >= 0`` marks an edge valid and ``dst``
is clamped at 0 (an edge with ``dst = -1`` lands on node 0); a node with no
valid in-edge has a softmax max of 0 and an output of 0; the denominator
is clamped at 1e-16; ``bias`` is drawn but never added; no self-loops; ELU
in f32 between layers.

PyTorch idiom: the segment ops run over the edges sorted by destination
(one stable sort a forward, shared by the layers, the bounds of each node's
run from ``torch.searchsorted``), reduced by ``torch.segment_reduce`` run
after run in a fixed order. JAX scatters; the port adds no float atomically
in the forward, so two calls on the card are bit-equal, and it reads
nothing back to the host. The (E, H, dh) messages are formed and summed in
chunks of sorted edges (:func:`edge_chunk`, a Python int from the shapes):
at ogb_products' 61.9 M edges the whole tensor would be 93 GB. A node whose
run spans two chunks gets the chunks' partial sums added in chunk order;
at Cora's size the one chunk is the same code path. Under grad, in more
than one chunk, the (E, H) softmax and each chunk are recomputed in the
backward pass, so training at ogb_products' size keeps one chunk's rows and
messages alive, not all of them (:func:`gat_layer`).

``init_params(key, cfg, device=None)`` draws the weights from a seeded
``torch.Generator`` (``key`` a seed, on the card unless ``device="cpu"``,
or a generator, on its device): JAX's distributions, not JAX's bits. The
parameters are named ``layers.{i}.w``, ``a_src``, ``a_dst`` and ``bias``,
JAX's pytree paths (``convert.gat_from_numpy`` / ``gat_to_numpy``).

Also the host-side fanout neighbour sampler (GraphSAGE-style) of the
``minibatch_lg`` shape, NumPy only and JAX's draws exactly: it samples a
2-hop block from a CSR graph into fixed-shape padded arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.backend import resolve_device
from repro_torch.models import layers

#: bytes of f32 messages a chunk of edges may hold (see :func:`edge_chunk`)
EDGE_CHUNK_BYTES = 1 << 32


@dataclasses.dataclass(frozen=True)
class GATConfig:
    name: str = "gat"
    n_layers: int = 2
    d_hidden: int = 8
    n_heads: int = 8
    d_in: int = 1433
    n_classes: int = 7
    negative_slope: float = 0.2
    dtype: Any = torch.float32


class GATLayer(nn.Module):
    """JAX's ``{"w", "a_src", "a_dst", "bias"}`` of one layer."""

    def __init__(self, d_in: int, n_heads: int, d_out: int, dtype, device):
        super().__init__()

        def param(*shape):
            return nn.Parameter(torch.zeros(shape, dtype=dtype,
                                            device=device))

        self.w = param(d_in, n_heads * d_out)
        self.a_src = param(n_heads, d_out)
        self.a_dst = param(n_heads, d_out)
        self.bias = param(n_heads * d_out)  # drawn, never added (as JAX)


class GAT(nn.Module):
    def __init__(self, cfg: GATConfig, device):
        super().__init__()
        self.cfg = cfg
        mods, d_in = [], cfg.d_in
        for i in range(cfg.n_layers):
            last = i == cfg.n_layers - 1
            d_out = cfg.n_classes if last else cfg.d_hidden
            mods.append(GATLayer(d_in, cfg.n_heads, d_out, cfg.dtype, device))
            d_in = d_out if last else cfg.n_heads * d_out
        self.layers = nn.ModuleList(mods)


def init_params(key, cfg: GATConfig, device=None) -> GAT:
    """Each layer in order: ``w`` by ``layers.dense_init``, ``a_src`` and
    ``a_dst`` normal x 0.1 (drawn in f32, then cast); ``bias`` zero."""
    g = (key if isinstance(key, torch.Generator)
         else torch.Generator(device=resolve_device(device)).manual_seed(key))
    model = GAT(cfg, g.device)
    with torch.no_grad():
        for p in model.layers:
            p.w.copy_(layers.dense_init(g, *p.w.shape, cfg.dtype))
            for a in (p.a_src, p.a_dst):
                a.copy_(torch.randn(a.shape, generator=g, device=g.device)
                        .mul_(0.1).to(cfg.dtype))
    return model


class EdgePlan(NamedTuple):
    """The edges sorted by destination (stable), for every layer of a
    forward: ``src`` and ``dst`` as gather indices (int64, clamped into
    [0, N), as JAX's gathers clamp), ``valid`` (src >= 0), and ``bounds``
    (N + 1,): node n's in-edges are ``[bounds[n], bounds[n + 1])``. Edges
    whose destination is past the last node lie beyond ``bounds[N]`` and
    join no segment, as JAX's segment ops drop them."""
    src: torch.Tensor
    dst: torch.Tensor
    valid: torch.Tensor
    bounds: torch.Tensor


def edge_plan(src: torch.Tensor, dst: torch.Tensor, n_nodes: int) -> EdgePlan:
    t, order = torch.sort(dst.long().clamp(min=0), stable=True)
    s = src.long()[order]
    bounds = torch.searchsorted(
        t, torch.arange(n_nodes + 1, device=t.device, dtype=t.dtype))
    return EdgePlan(src=s.clamp(0, n_nodes - 1), dst=t.clamp(max=n_nodes - 1),
                    valid=s >= 0, bounds=bounds)


def edge_chunk(n_edges: int, n_nodes: int, n_heads: int, d_head: int) -> int:
    """Edges a chunk of the aggregation sums: as many as ``EDGE_CHUNK_BYTES``
    of f32 messages hold, but no fewer than ``n_nodes`` (each chunk writes an
    (N, H, dh) partial sum, so fewer would cost more in partials than in
    messages), and no more than ``n_edges``."""
    per_edge = 4 * n_heads * d_head
    return max(1, min(n_edges, max(n_nodes, EDGE_CHUNK_BYTES // per_edge)))


def _segments(x: torch.Tensor, reduce: str, bounds: torch.Tensor):
    """``reduce`` ("sum" or "max") of each node's run of the sorted rows
    ``x``, in row order: (N, ...). An empty run gives 0 (sum) or -inf (max).
    ``unsafe=True`` skips the length checks, which read back to the host."""
    return torch.segment_reduce(x, reduce, lengths=bounds.diff(), unsafe=True)


def _edge_softmax(e_src: torch.Tensor, e_dst: torch.Tensor,
                  plan: EdgePlan, slope: float) -> torch.Tensor:
    """Each edge's attention coefficient (E, H) in f32: LeakyReLU of its
    endpoints' scores, softmax over each destination's valid in-edges (0 on
    an invalid edge), the denominator clamped at 1e-16."""
    valid = plan.valid[:, None]
    logits = F.leaky_relu((e_src[plan.src] + e_dst[plan.dst]).float(), slope)
    logits = logits.masked_fill(~valid, -torch.inf)  # (E, H), sorted
    # the max only steadies the exponent: the softmax does not depend on it,
    # so no gradient flows through it
    seg_max = _segments(logits.detach(), "max", plan.bounds)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    ex = torch.where(valid, torch.exp(logits - seg_max[plan.dst]), 0.0)
    denom = _segments(ex, "sum", plan.bounds)
    return ex / denom[plan.dst].clamp(min=1e-16)


def _chunk_sum(h: torch.Tensor, coef: torch.Tensor, src: torch.Tensor,
               bounds: torch.Tensor) -> torch.Tensor:
    """One chunk's messages ``h[src] * coef`` (C, H, dh) summed over each
    node's run of it (``bounds`` clamped to the chunk): (N, H, dh)."""
    return _segments(h[src].float() * coef[:, :, None], "sum", bounds)


def gat_layer(p: GATLayer, x: torch.Tensor, src: torch.Tensor,
              dst: torch.Tensor, n_nodes: int, *, n_heads: int, slope: float,
              average_heads: bool, plan: EdgePlan | None = None,
              chunk: int | None = None) -> torch.Tensor:
    """One GAT layer. x: (N, d_in); src/dst: (E,) (-1 = padding edge), or
    their ``plan`` from :func:`edge_plan`; ``chunk`` edges a chunk of the
    messages (default :func:`edge_chunk`).

    Under grad, when the edges take more than one chunk, the (E, H) softmax
    and each chunk's messages are recomputed in the backward pass
    (``torch.utils.checkpoint``): the layer keeps its coefficients and the
    plan, and one chunk's gathered rows and messages are alive at a time
    (autograd's saved form would keep 2 x 93 GB at ogb_products' last
    layer). In one chunk autograd saves them. The forward is the same
    either way, bit for bit."""
    plan = edge_plan(src, dst, n_nodes) if plan is None else plan
    h = (x @ p.w).view(x.shape[0], n_heads, -1)  # (N, H, dh)
    n_edges = plan.src.shape[0]
    chunk = chunk or edge_chunk(n_edges, n_nodes, n_heads, h.shape[-1])
    remat = torch.is_grad_enabled() and n_edges > chunk

    def run(fn, *args):
        return checkpoint(fn, *args, use_reentrant=False) if remat else fn(
            *args)

    e_src = (h * p.a_src[None]).sum(-1)  # (N, H)
    e_dst = (h * p.a_dst[None]).sum(-1)
    coef = run(_edge_softmax, e_src, e_dst, plan, slope)
    out = None
    for c0 in range(0, max(n_edges, 1), chunk):
        c1 = min(c0 + chunk, n_edges)
        part = run(_chunk_sum, h, coef[c0:c1], plan.src[c0:c1],
                   plan.bounds.clamp(c0, c1))
        out = part if out is None else out + part  # (N, H, dh)
    if average_heads:
        return out.mean(1).to(x.dtype)
    return out.reshape(n_nodes, -1).to(x.dtype)


def forward(model: GAT, x: torch.Tensor, src: torch.Tensor,
            dst: torch.Tensor, *, chunk: int | None = None) -> torch.Tensor:
    """(N, d_in) features, (E,) edges -> (N, n_classes) logits."""
    cfg = model.cfg
    n = x.shape[0]
    plan = edge_plan(src, dst, n)
    h = x.to(cfg.dtype)
    for i, p in enumerate(model.layers):
        last = i == cfg.n_layers - 1
        h = gat_layer(p, h, src, dst, n, n_heads=cfg.n_heads,
                      slope=cfg.negative_slope, average_heads=last,
                      plan=plan, chunk=chunk)
        if not last:
            h = F.elu(h.float()).to(cfg.dtype)
    return h


def loss_fn(model: GAT, batch: dict, *, chunk: int | None = None):
    """batch: feats (N, F), src/dst (E,), labels (N,), mask (N,) ->
    (masked mean cross entropy, {"loss", "acc"})."""
    logits = forward(model, batch["feats"], batch["src"], batch["dst"],
                     chunk=chunk)
    lf = logits.float()
    labels = batch["labels"].long()
    per_node = (torch.logsumexp(lf, dim=-1)
                - lf.gather(-1, labels[:, None])[:, 0])
    mask = batch["mask"].float()
    count = mask.sum().clamp(min=1.0)
    loss = (per_node * mask).sum() / count
    acc = ((lf.argmax(-1) == labels) * mask).sum() / count
    return loss, {"loss": loss, "acc": acc}


# --------------------------------------------------------------------------
# host-side neighbor sampler (minibatch_lg): JAX's, NumPy only
# --------------------------------------------------------------------------
class SampledBlock(NamedTuple):
    feats: np.ndarray  # (n_max, F) padded node features
    src: np.ndarray  # (e_max,) local edge endpoints, -1 padded
    dst: np.ndarray
    labels: np.ndarray  # (n_max,)
    mask: np.ndarray  # (n_max,) 1 on seed nodes
    n_nodes: int


class CSRGraph(NamedTuple):
    indptr: np.ndarray
    indices: np.ndarray
    feats: np.ndarray
    labels: np.ndarray


def random_csr_graph(n_nodes: int, avg_degree: int, d_feat: int,
                     n_classes: int, seed: int = 0) -> CSRGraph:
    rng = np.random.default_rng(seed)
    degs = rng.poisson(avg_degree, size=n_nodes).astype(np.int64)
    indptr = np.concatenate([[0], np.cumsum(degs)])
    indices = rng.integers(0, n_nodes, size=int(indptr[-1]))
    feats = rng.normal(size=(n_nodes, d_feat)).astype(np.float32)
    labels = rng.integers(0, n_classes, size=n_nodes).astype(np.int32)
    return CSRGraph(indptr, indices, feats, labels)


def sample_block(g: CSRGraph, seeds: np.ndarray, fanouts: tuple[int, ...],
                 rng: np.random.Generator) -> SampledBlock:
    """GraphSAGE fanout sampling; returns a fixed-shape padded block."""
    n_max = len(seeds)
    f_prod = 1
    for f in fanouts:
        f_prod *= f
        n_max += len(seeds) * f_prod
    e_max = n_max  # one sampled edge per non-seed node (tree block) upper bound

    nodes = list(seeds)
    local = {int(v): i for i, v in enumerate(seeds)}
    src_l, dst_l = [], []
    frontier = list(seeds)
    for f in fanouts:
        nxt = []
        for v in frontier:
            lo, hi = g.indptr[v], g.indptr[v + 1]
            if hi <= lo:
                continue
            nbrs = g.indices[rng.integers(lo, hi, size=min(f, hi - lo))]
            for u in nbrs:
                u = int(u)
                if u not in local:
                    local[u] = len(nodes)
                    nodes.append(u)
                src_l.append(local[u])
                dst_l.append(local[int(v)])
                nxt.append(u)
        frontier = nxt
    n = len(nodes)
    feats = np.zeros((n_max, g.feats.shape[1]), np.float32)
    feats[:n] = g.feats[nodes]
    labels = np.zeros((n_max,), np.int32)
    labels[:n] = g.labels[nodes]
    src = np.full((e_max,), -1, np.int32)
    dst = np.full((e_max,), -1, np.int32)
    src[: len(src_l)] = src_l
    dst[: len(dst_l)] = dst_l
    mask = np.zeros((n_max,), np.float32)
    mask[: len(seeds)] = 1.0
    return SampledBlock(feats, src, dst, labels, mask, n)
