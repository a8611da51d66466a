"""GNN-produced corpus + bi-metric search, the twin of
``examples/gnn_corpus_search.py``: GAT node embeddings become the expensive
metric D (2-layer message passing per node), while raw node features
projected down serve as the cheap proxy d.

    python -m repro_torch.launch.gnn_corpus_search            # the example's size
    python -m repro_torch.launch.gnn_corpus_search --n-nodes 169343 \\
        --avg-degree 7 --d-feat 128 --n-queries 64           # ogbn-arxiv's size

The graph is ``gnn.random_csr_graph`` (edges from each node to its CSR
neighbours); the index is built on d only; each query's stage 2 spends at
most Q D calls, each a ``gather_score`` over the GAT embeddings. Recall@10
is against the brute-force top-10 under D. Runs on the card;
``--device cpu`` runs the plain versions on the CPU.
"""
from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from repro_torch.core import bimetric, distances, metrics, vamana
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import gnn

#: the example's widths: GAT(d_in, 32 out, d_hidden 16, 4 heads) and the
#: proxy's 8 dims
D_OUT, D_HIDDEN, N_HEADS, D_PROXY = 32, 16, 4, 8
INDEX = vamana.VamanaConfig(max_degree=16, l_build=24, pool_size=48,
                            rev_candidates=16)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    """Returns recall@10 and the D calls of every query at each quota, the
    seconds of the embedding, the build and each search, and under
    ``"state"`` the index, the corpus's and the queries' embeddings."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-nodes", type=int, default=2048)
    ap.add_argument("--avg-degree", type=int, default=8)
    ap.add_argument("--d-feat", type=int, default=64)
    ap.add_argument("--n-queries", type=int, default=16)
    ap.add_argument("--quotas", default="64,256",
                    help="comma-separated D-call budgets")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n = args.n_nodes

    g = gnn.random_csr_graph(n_nodes=n, avg_degree=args.avg_degree,
                             d_feat=args.d_feat, n_classes=8, seed=0)
    src = torch.from_numpy(np.repeat(np.arange(n), np.diff(g.indptr))
                           .astype(np.int32)).to(dev)
    dst = torch.from_numpy(g.indices.astype(np.int32)).to(dev)
    feats = torch.from_numpy(g.feats).to(dev)

    cfg = gnn.GATConfig(d_in=args.d_feat, n_classes=D_OUT, n_layers=2,
                        d_hidden=D_HIDDEN, n_heads=N_HEADS)
    model = gnn.init_params(0, cfg, device=dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        emb_D = gnn.forward(model, feats, src, dst)  # (N, 32) structural
        gen = torch.Generator(device=dev).manual_seed(1)
        proj = torch.randn(args.d_feat, D_PROXY, device=dev, generator=gen)
        emb_d = feats @ (proj / math.sqrt(D_PROXY))  # cheap: no messages
    _sync(dev)
    embed_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    index = vamana.build(emb_d, INDEX, device=dev)
    _sync(dev)
    build_s = time.perf_counter() - t0
    em_d = distances.EmbeddingMetric(emb_d)
    em_D = distances.EmbeddingMetric(emb_D)
    qids = torch.from_numpy(np.random.default_rng(0).integers(
        0, n, args.n_queries)).to(dev)
    q_d, q_D = emb_d[qids], emb_D[qids]
    true_ids, _ = em_D.brute_force(q_D, 10)
    out = dict(n_nodes=n, n_edges=int(g.indptr[-1]), embed_s=embed_s,
               build_s=build_s, recall_at_10={}, D_calls={}, query_s={})
    for quota in (int(q) for q in args.quotas.split(",")):
        t0 = time.perf_counter()
        res = bimetric.bimetric_search(
            em_d.dists_batch, em_D.dists_batch, index, q_d, q_D,
            n_points=n, quota=quota, k=10, device=dev)
        _sync(dev)
        out["query_s"][quota] = time.perf_counter() - t0
        rec = float(metrics.recall_at_k(res.ids, true_ids).float().mean())
        out["recall_at_10"][quota] = rec
        out["D_calls"][quota] = res.D_calls.tolist()
        print(f"Q={quota}: recall@10 vs GAT metric = {rec:.3f} "
              f"(vs brute force = {n} D calls)")
    out["state"] = dict(index=index, emb_d=emb_d, emb_D=emb_D, q_d=q_d,
                        q_D=q_D)
    return out


if __name__ == "__main__":
    main()
