#!/usr/bin/env python3
"""Drive the PyTorch port's bi-metric query path on one NVIDIA GPU.

    python3 chip_smoke.py [--n 171332] [--report PATH]

Phases (any failure exits nonzero and prints no result line):

1. environment and build: the card's name and power limit, the torch
   version, and the nvcc build of every ``src/repro_torch/kernels/csrc/*.cu``
   (cached under ``build/``);
2. each hand-written kernel against its plain PyTorch version on the card, at
   the slice's shapes, with median times (CUDA events), bounds and yardsticks;
3. cross-check of the whole slice at N=8192 (dims 384/4096): the same graph
   searched on the card and with ``device="cpu"``, and two N=2048 builds
   from one initial graph;
4. the full slice: ``make_dataset`` at the TREC-COVID corpus size, Vamana
   build with the paper's DiskANN parameters, ``bimetric_search`` and
   ``rerank_search`` at Q in {100, 1000}, recall@10 / nDCG@10 against the
   brute-force top-10 under D.

Ends with a JSON line per ported kernel and the result line
``{"ok": true, "device": {...}}``. Needs one CUDA device; imports no JAX.
``--rehearse`` runs the control flow on the CPU at toy sizes and exits 3.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): HBM rate and f32 rate outside the
# tensor cores — the kernels here do f32 scalar arithmetic
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

CROSS_RTOL = 1e-5  # near-tie allowance between the card and the CPU

# cluster size of the generator's defaults (n=4096, n_clusters=64): kept as
# N grows, so the D-neighbourhoods stay as local as at the default size
POINTS_PER_CLUSTER = 64


def require(cond, msg="check failed"):
    """A check that holds under ``python -O`` too."""
    if not cond:
        raise AssertionError(msg)


def log(*a):
    print(*a, flush=True)


def time_ms(fn, reps=11, inner=10, warmup=3):
    """Per-call device time of ``fn`` (ms): the median over ``reps`` CUDA-event
    windows of ``inner`` back-to-back calls each, so the host's launch work
    overlaps the device's instead of being counted."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(inner):
            fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / inner)
    return statistics.median(times)


def bound(nbytes, nops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------------
# phase 2: kernels vs plain versions
# --------------------------------------------------------------------------
def _term_scale(view, q, ids, metric):
    """Per-lane magnitude of the terms a score sums: a lane's tolerance is
    relative to it, since a sum of 4096 products that cancels to near zero
    keeps the rounding of its terms (f32 sums in another order)."""
    xsq = view.sq_norms[ids.clamp(min=0).long()]
    qsq = (q.float() * q.float()).sum(-1)[:, None]
    if metric == "ip":
        return torch.sqrt(xsq * qsq)
    if metric == "sqeuclidean":
        return xsq + qsq
    if metric == "l2":
        return torch.sqrt(xsq + qsq)
    return torch.ones_like(xsq)


def check_gather(dev, n, dims, ks, b, timing, rehearse):
    from repro_torch.kernels import backend, l2_topk

    g = torch.Generator(device=dev).manual_seed(11)
    max_err, rows_out = 0.0, []
    timed = None
    for dim in dims:
        corpus = torch.randn(n, dim, generator=g, device=dev)
        corpus[7] = 0.0
        q = torch.randn(b, dim, generator=g, device=dev)
        views = {"f32": backend.as_corpus_view(corpus)}
        for mode in ("int8", "fp8", "fp8_e5m2"):
            views[mode] = backend.as_corpus_view(corpus, quantize=mode)
        for k in ks:
            ids = torch.randint(-1, n, (b, k), generator=g, device=dev,
                                dtype=torch.int32)
            ids[:, :: 9] = -1  # padding lanes
            ids[:, 1] = 7  # the zero row
            for metric in l2_topk.VALID_METRICS:
                for name, view in views.items():
                    meta = l2_topk.pack_row_meta(view)
                    forms = [(False, None if name == "f32" else meta),
                             (True, meta)]
                    for mm, m in forms:
                        got = l2_topk.gather_score(view.rows, q, ids,
                                                   metric=metric, meta=m,
                                                   matmul=mm)
                        want = l2_topk.gather_score_plain(
                            view.rows, q, ids, metric=metric, meta=m,
                            matmul=mm)
                        tol = 1e-5 if name == "f32" else 1e-4
                        fin = torch.isfinite(want)
                        require(torch.equal(fin, torch.isfinite(got)))
                        scale = _term_scale(view, q, ids, metric)
                        err = (got[fin] - want[fin]).abs()
                        lim = tol * torch.maximum(want[fin].abs(), scale[fin])
                        require(bool((err <= lim).all()),
                                f"gather {dim} {k} {metric} {name} mm={mm}: "
                                f"max err {float(err.max()):.3e}")
                        if metric == "cosine":
                            require((got[:, 1] == 1.0).all())
                        max_err = max(max_err, float(
                            (got[fin] - want[fin]).abs().max()))
        # times at the main path's shapes and form (gather-then-reduce over
        # f32 rows, every lane live, rows drawn from the whole corpus)
        for tb, tk in timing.get(dim, ()):
            qt = torch.randn(tb, dim, generator=g, device=dev)
            live = torch.randint(0, n, (tb, tk), generator=g, device=dev,
                                 dtype=torch.int32)
            row = dict(dim=dim, B=tb, K=tk)
            nbytes = tb * tk * dim * 4 + tb * dim * 4 + 2 * tb * tk * 4
            row["bound_ms"], row["bound_by"] = bound(nbytes, 3 * tb * tk * dim)
            if not rehearse:
                row["ms"] = time_ms(lambda: l2_topk.gather_score(
                    corpus, qt, live, metric="l2"))
                row["plain_ms"] = time_ms(lambda: l2_topk.gather_score_plain(
                    corpus, qt, live, metric="l2"), reps=5, inner=2)
            rows_out.append(row)
            if timed is None and dim == max(dims):
                timed = row  # the stage-2 wave
        del corpus, views
    return max_err, rows_out, timed


def _merge_inputs(dev, b, p, k, g):
    pi = torch.randint(0, 1 << 20, (b, p), generator=g, device=dev,
                       dtype=torch.int32)
    pd = torch.randint(0, 64, (b, p), generator=g, device=dev).float()
    pd = torch.sort(pd, dim=1).values  # integer dists: many ties
    pd[:, -7:] = float("inf")
    pi[:, -7:] = -1
    pf = torch.rand(b, p, generator=g, device=dev) < 0.5
    ci = torch.randint(-1, 1 << 20, (b, k), generator=g, device=dev,
                       dtype=torch.int32)
    cd = torch.randint(0, 64, (b, k), generator=g, device=dev).float()
    cd[ci < 0] = float("inf")
    ci[0], cd[0] = -1, float("inf")  # an all-masked wave
    return pi, pd, pf, ci, cd


def check_merge(dev, shapes, rehearse):
    from repro_torch.kernels import l2_topk, ref

    g = torch.Generator(device=dev).manual_seed(12)
    rows_out, timed = [], None
    for b, p, k in shapes:
        pi, pd, pf, ci, cd = _merge_inputs(dev, b, p, k, g)
        got = l2_topk.merge_pool_batch(pi, pd, pf, ci, cd)
        want = ref.merge_pool_batch_ref(pi, pd, pf, ci, cd)
        for name, x, y in zip(("ids", "dists", "flags"), got, want):
            require(torch.equal(x, y), f"merge ({p},{k}) {name} differs")
        require(torch.equal(got[0][0], pi[0]) and torch.equal(got[2][0], pf[0]))
        n_pad = 1 << (p + k - 1).bit_length()
        m = n_pad.bit_length() - 1
        nbytes = b * (p + k) * 8 + b * p + b * p * 9
        row = dict(P=p, K=k, B=b)
        row["bound_ms"], row["bound_by"] = bound(
            nbytes, b * (n_pad // 2) * m * (m + 1) // 2)
        if not rehearse:
            row["ms"] = time_ms(lambda: l2_topk.merge_pool_batch(
                pi, pd, pf, ci, cd))
            row["plain_ms"] = time_ms(lambda: ref.merge_pool_batch_ref(
                pi, pd, pf, ci, cd))
            cat = torch.cat([pd, cd], dim=1)
            row["library_ms"] = time_ms(
                lambda: torch.sort(cat, dim=1, stable=True))
        rows_out.append(row)
        if (p, k) == (1000, 64):
            timed = row
    return 0.0, rows_out, timed or rows_out[-1]


# --------------------------------------------------------------------------
# phase 3: the slice on the card vs on the CPU
# --------------------------------------------------------------------------
def _lockstep(fn_a, fn_b, ctx_a, ctx_b, adj_a, adj_b, entries, n, **kw):
    """Run one query's search step by step on two devices; return the first
    pool divergence as (ids_a, dists_a, ids_b, dists_b) or None."""
    from repro_torch.core import beam

    quota, L, P, max_steps = kw["quota"], kw["beam_width"], kw["pool"], kw[
        "max_steps"]

    def start(fn, ctx, adj):
        e = entries.to(adj.device)
        s, safe, keep = beam.init_state(e, n_points=n, pool_size=P,
                                        quota=quota)
        return beam.commit_scores(s, safe, keep, fn(ctx, safe))

    sa, sb = start(fn_a, ctx_a, adj_a), start(fn_b, ctx_b, adj_b)
    while True:
        if not torch.equal(sa.pool_ids.cpu(), sb.pool_ids.cpu()) or not (
                torch.equal(sa.n_calls.cpu(), sb.n_calls.cpu())):
            return (sa.pool_ids[0].cpu(), sa.pool_dists[0].cpu(),
                    sb.pool_ids[0].cpu(), sb.pool_dists[0].cpu())
        act = beam.active_mask(sa, beam_width=L, quota=quota,
                               max_steps=max_steps)
        if not bool(act.any()):
            return None
        out = []
        for s, fn, ctx, adj in ((sa, fn_a, ctx_a, adj_a),
                                (sb, fn_b, ctx_b, adj_b)):
            s, safe, keep, _ = beam.plan_step(s, adj, beam_width=L,
                                              quota=quota,
                                              max_steps=max_steps)
            out.append(beam.commit_scores(s, safe, keep, fn(ctx, safe)))
        sa, sb = out


def _tie_gap(ids_a, ids_b, dist_of):
    """Relative gap between the two candidates at the first position where
    two rankings differ, with both scored by ``dist_of`` (one device)."""
    i = int((ids_a != ids_b).nonzero()[0])
    da, db = dist_of(int(ids_a[i])), dist_of(int(ids_b[i]))
    return abs(da - db) / max(abs(da), abs(db), 1e-30), (int(ids_a[i]),
                                                         int(ids_b[i]))


def _first_gap(cfg):
    """Trace one stage of one query in lockstep on both devices; returns the
    near-tie gap at its first divergence (None if the stage agrees)."""
    div = _lockstep(*cfg["fns"], *cfg["ctx"], *cfg["adj"], cfg["entries"],
                    cfg["n"], **cfg["kw"])
    if div is None:
        return None
    ia, _, ib, _ = div
    if torch.equal(ia, ib):
        return float("inf"), None  # counts differ while the pools agree
    fn_cpu, q_cpu = cfg["fns"][1], cfg["ctx"][1]
    return _tie_gap(ia, ib, lambda v: float(
        fn_cpu(q_cpu, torch.tensor([[v]], dtype=torch.int32))[0, 0]))


def cross_check(dev, n, dim_d, dim_D, n_queries, quotas, build_n):
    from repro_torch.configs.bimetric_paper import PAPER_DISKANN
    from repro_torch.core import bimetric, distances, vamana
    from repro_torch.data.synthetic import make_dataset, proxy_quality_sweep

    cpu = torch.device("cpu")
    noise = {k: v for k, v in proxy_quality_sweep("bge-micro-like").items()
             if k != "dim_d"}
    data = make_dataset(n=n, n_queries=n_queries, dim_D=dim_D, dim_d=dim_d,
                        n_clusters=n // POINTS_PER_CLUSTER, seed=3,
                        device=dev, **noise)
    cfg = PAPER_DISKANN._replace(build_batch=min(PAPER_DISKANN.build_batch, n))
    t0 = time.perf_counter()
    idx = vamana.build(data.corpus_d, cfg, device=dev)
    log(f"  cross-check build N={n}: {time.perf_counter() - t0:.3f} s")
    gpu = dict(cd=data.corpus_d, cD=data.corpus_D, qd=data.queries_d,
               qD=data.queries_D, adj=idx.adjacency)
    host = {k: v.cpu() for k, v in gpu.items()}
    idx_cpu = idx._replace(adjacency=host["adj"])
    allowed = []
    for side in (gpu, host):
        side["fd"] = distances.EmbeddingMetric(side["cd"]).dists_batch
        side["fD"] = distances.EmbeddingMetric(side["cD"]).dists_batch
    for q in quotas:
        for method in ("bimetric", "rerank"):
            fn = (bimetric.bimetric_search if method == "bimetric"
                  else bimetric.rerank_search)
            res = {}
            for name, side, ix, d in (("card", gpu, idx, dev),
                                      ("cpu", host, idx_cpu, cpu)):
                res[name] = fn(side["fd"], side["fD"], ix, side["qd"],
                               side["qD"], n_points=n, quota=q, k=10,
                               device=d)
            a, c = res["card"], res["cpu"]
            require(int(a.D_calls.max()) <= q)
            for b in range(n_queries):
                same = (torch.equal(a.ids[b].cpu(), c.ids[b])
                        and int(a.d_calls[b]) == int(c.d_calls[b])
                        and int(a.D_calls[b]) == int(c.D_calls[b]))
                if same:
                    torch.testing.assert_close(a.dists[b].cpu(), c.dists[b],
                                               rtol=1e-4, atol=1e-4)
                    continue
                stage, gap, pair = _explain(b, method, q, gpu, host, idx,
                                            idx_cpu, n, a, c)
                ok = gap <= CROSS_RTOL
                log(f"  query {b} ({method}, Q={q}) differs at {stage}: "
                    f"candidates {pair}, relative gap {gap:.3e} "
                    f"({'near-tie, allowed' if ok else 'NOT a near-tie'})")
                require(ok, f"query {b} differs beyond a near-tie")
                allowed.append(dict(method=method, Q=q, query=b, stage=stage,
                                    gap=gap))
    log(f"  slice card vs cpu: {n_queries} queries x {len(quotas)} quotas x "
        f"2 methods, {len(allowed)} near-tie differences")

    # two builds from one initial graph, on both devices
    gen = torch.Generator().manual_seed(5)
    x = data.corpus_d[:build_n]
    r = PAPER_DISKANN.max_degree
    init = torch.randint(0, build_n, (build_n, r), generator=gen,
                         dtype=torch.int32)
    init[init == torch.arange(build_n, dtype=torch.int32)[:, None]] = -1
    bcfg = PAPER_DISKANN._replace(build_batch=min(1024, build_n))
    ia = vamana.build(x, bcfg, init_adjacency=init, device=dev)
    ib = vamana.build(x.cpu(), bcfg, init_adjacency=init, device=cpu)
    same_rows = float((ia.adjacency.cpu() == ib.adjacency).all(1).float()
                      .mean())
    log(f"  build N={build_n} card vs cpu: medoid {ia.medoid} / {ib.medoid}, "
        f"{same_rows:.4f} of adjacency rows identical")
    require(ia.medoid == ib.medoid)
    require(same_rows >= 0.99, same_rows)
    return dict(near_ties=allowed, build_rows_identical=same_rows)


def _explain(b, method, q, gpu, host, idx, idx_cpu, n, a, c):
    """Trace query b of one method/quota to its first divergence."""
    from repro_torch.core.beam import NO_QUOTA

    cfg1 = idx.config
    sl = slice(b, b + 1)
    if method == "bimetric":
        n_seeds = max(1, q // 2)
        l1 = max(cfg1.l_build, n_seeds)
        bw = max(10, min(q, 2 * n_seeds + 8))
        kw2 = dict(quota=q, beam_width=bw, pool=max(bw, 10),
                   max_steps=4 * q)
    else:
        n_seeds, l1 = q, max(cfg1.l_build, q)
    kw1 = dict(quota=NO_QUOTA, beam_width=l1, pool=max(l1, n_seeds),
               max_steps=4 * l1)
    entry = torch.full((1, 1), int(idx.medoid), dtype=torch.int32)
    stage1 = dict(fns=(gpu["fd"], host["fd"]),
                  ctx=(gpu["qd"][sl], host["qd"][sl]),
                  adj=(idx.adjacency, idx_cpu.adjacency), entries=entry,
                  n=n, kw=kw1)
    found = _first_gap(stage1)
    if found is not None:
        return ("stage 1", *found)
    # stage 1 agrees: the difference is in stage 2 (or the re-rank sort)
    from repro_torch.core import beam
    res1 = beam.batched_greedy_search(
        host["fd"], idx_cpu.adjacency, host["qd"][sl], entry, n_points=n,
        beam_width=l1, pool_size=max(l1, n_seeds), max_steps=4 * l1)
    seeds = res1.pool_ids[:, :n_seeds]
    if method == "rerank":
        ids_a, ids_c = a.ids[b].cpu(), c.ids[b]

        def dist_of(v):
            return float(host["fD"](host["qD"][sl],
                                    torch.tensor([[v]], dtype=torch.int32))[0, 0])

        gap, pair = _tie_gap(ids_a, ids_c, dist_of)
        return "re-rank sort", gap, pair
    stage2 = dict(fns=(gpu["fD"], host["fD"]),
                  ctx=(gpu["qD"][sl], host["qD"][sl]),
                  adj=(idx.adjacency, idx_cpu.adjacency), entries=seeds,
                  n=n, kw=kw2)
    found = _first_gap(stage2)
    return ("stage 2", *found) if found else ("unexplained", float("inf"),
                                               None)


# --------------------------------------------------------------------------
# phase 4: the full slice
# --------------------------------------------------------------------------
def full_slice(dev, n, dim_d, dim_D, n_queries, quotas, rehearse):
    from repro_torch.configs.bimetric_paper import (PAPER_DISKANN,
                                                    BiMetricSystemConfig)
    from repro_torch.core import bimetric, distances, metrics, vamana
    from repro_torch.data.synthetic import make_dataset, proxy_quality_sweep
    from repro_torch.kernels import l2_topk

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    noise = {k: v for k, v in proxy_quality_sweep("bge-micro-like").items()
             if k != "dim_d"}
    t0 = time.perf_counter()
    data = make_dataset(n=n, n_queries=n_queries, dim_D=dim_D, dim_d=dim_d,
                        n_clusters=n // POINTS_PER_CLUSTER, seed=0,
                        device=dev, **noise)
    sync()
    out = dict(N=n, dim_d=dim_d, dim_D=dim_D, queries=n_queries,
               n_clusters=n // POINTS_PER_CLUSTER,
               c_estimate=data.c_estimate,
               data_s=time.perf_counter() - t0)
    k = BiMetricSystemConfig().k
    em_d = distances.EmbeddingMetric(data.corpus_d)
    em_D = distances.EmbeddingMetric(data.corpus_D)
    true_ids, _ = em_D.brute_force(data.queries_D, k)

    l2_topk.reset_launches()  # the main path starts here
    cfg = PAPER_DISKANN._replace(build_batch=min(PAPER_DISKANN.build_batch, n))
    t0 = time.perf_counter()
    idx = vamana.build(data.corpus_d, cfg, device=dev)
    sync()
    out["build_s"] = time.perf_counter() - t0
    log(f"  build N={n}: {out['build_s']:.3f} s")
    build_launches = dict(l2_topk.launches)
    runs = []
    for q in quotas:
        for method in ("bimetric", "rerank"):
            fn = (bimetric.bimetric_search if method == "bimetric"
                  else bimetric.rerank_search)
            before = dict(l2_topk.launches)
            t0 = time.perf_counter()
            res = fn(em_d.dists_batch, em_D.dists_batch, idx, data.queries_d,
                     data.queries_D, n_points=n, quota=q, k=k, device=dev)
            sync()
            dt = time.perf_counter() - t0
            require(res.ids.shape == (n_queries, k))
            require(torch.isfinite(res.dists).all())
            require(int(res.D_calls.max()) <= q, (method, q))
            run = dict(method=method, Q=q, query_s=dt, qps=n_queries / dt,
                       recall_at_10=float(metrics.recall_at_k(
                           res.ids, true_ids).mean()),
                       ndcg_at_10=float(metrics.ndcg_at_k(
                           res.ids, true_ids).mean()),
                       mean_D_calls=float(res.D_calls.float().mean()),
                       max_D_calls=int(res.D_calls.max()),
                       mean_d_calls=float(res.d_calls.float().mean()),
                       launches={kk: l2_topk.launches[kk] - before[kk]
                                 for kk in before})
            log(f"  {method:8s} Q={q:5d}: {dt:.3f} s, {run['qps']:.1f} q/s, "
                f"recall@10 {run['recall_at_10']:.4f}, nDCG@10 "
                f"{run['ndcg_at_10']:.4f}, D_calls mean "
                f"{run['mean_D_calls']:.1f} max {run['max_D_calls']}, "
                f"d_calls mean {run['mean_d_calls']:.1f}")
            runs.append(run)
    launches = dict(l2_topk.launches)  # read just after the main path
    out.update(runs=runs, launches=launches, build_launches=build_launches)
    if dev.type == "cuda":
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        log(f"  max_memory_allocated {out['max_memory_allocated']} bytes")
    if not rehearse:
        for name, cnt in launches.items():
            require(cnt > 0, f"{name} was never launched on the main path")
    return out


# --------------------------------------------------------------------------
def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=171_332,
                    help="corpus size of the full slice (TREC-COVID: 171,332)")
    ap.add_argument("--report", type=str, default=None,
                    help="write every measured number to this JSON file")
    ap.add_argument("--rehearse", action="store_true",
                    help="toy sizes on the CPU; never prints a result")
    args = ap.parse_args()

    rehearse = args.rehearse
    if not rehearse and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, l2_topk

    dev = torch.device("cpu" if rehearse else "cuda")
    report = dict(torch=torch.__version__)
    smi = "not measured"
    if not rehearse:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    log(f"phase 1: card {smi}; torch {torch.__version__} "
        f"(CUDA {torch.version.cuda})")
    report["card"] = smi
    if not rehearse:
        t0 = time.perf_counter()
        _build.build_all()
        report["build_kernels_s"] = time.perf_counter() - t0
        log(f"  kernels built in {report['build_kernels_s']:.3f} s "
            f"(nvcc {_build.last_build_seconds:.3f} s) into {_build.build_dir()}")

    if rehearse:
        sizes = dict(n=3000, dims=(16, 48), ks=(8, 20), b=4,
                     timing={16: ((4, 8),), 48: ((4, 20),)},
                     shapes=((4, 16, 8),), cn=600, cd=8, cD=32, cq=4, quotas=(20, 60), bn=300,
                     fn=800, fq=8)
    else:
        # timing shapes: build wave (B=1024), stage-1 wave, stage-2 wave,
        # stage-2 entry wave (K = Q/2 seeds), re-rank scoring wave (K = Q)
        sizes = dict(n=args.n, dims=(384, 4096), ks=(64, 500, 1000), b=256,
                     timing={384: ((1024, 64), (256, 64)),
                             4096: ((256, 64), (256, 500), (256, 1000))},
                     shapes=((1024, 256, 64), (256, 500, 64), (256, 1000, 64),
                             (256, 1000, 500)), cn=8192, cd=384, cD=4096, cq=16,
                     quotas=(100, 1000), bn=2048, fn=args.n, fq=256)

    t0 = time.perf_counter()
    log("phase 2: kernels vs plain versions")
    g_err, g_rows, g_timed = check_gather(dev, sizes["n"], sizes["dims"],
                                          sizes["ks"], sizes["b"],
                                          sizes["timing"], rehearse)
    m_err, m_rows, m_timed = check_merge(dev, sizes["shapes"], rehearse)
    for r in g_rows + m_rows:
        log("  " + json.dumps(r))
    report.update(gather=g_rows, merge=m_rows, phase2_s=time.perf_counter() - t0)
    log(f"  gather_score max |kernel - plain| {g_err:.3e}; merge exact")

    t0 = time.perf_counter()
    log("phase 3: the slice on the card vs on the CPU")
    report["cross"] = cross_check(dev, sizes["cn"], sizes["cd"], sizes["cD"],
                                  sizes["cq"], sizes["quotas"], sizes["bn"])
    report["phase3_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    log("phase 4: the full slice")
    full = full_slice(dev, sizes["fn"], sizes["cd"], sizes["cD"], sizes["fq"],
                      sizes["quotas"], rehearse)
    report["full"] = full
    report["phase4_s"] = time.perf_counter() - t0

    kernels = [
        dict(name="gather_score", route="cuda",
             source="src/repro_torch/kernels/csrc/l2_topk.cu",
             replaces="src/repro/kernels/l2_topk.py:158",
             launches=full["launches"]["gather_score"], max_abs_err=g_err,
             ms=g_timed.get("ms"), plain_ms=g_timed.get("plain_ms"),
             bound_ms=g_timed["bound_ms"], bound_by=g_timed["bound_by"],
             library_ms=None),
        dict(name="beam_merge_topk", route="cuda",
             source="src/repro_torch/kernels/csrc/l2_topk.cu",
             replaces="src/repro/kernels/l2_topk.py:355",
             launches=full["launches"]["beam_merge_topk"], max_abs_err=m_err,
             ms=m_timed.get("ms"), plain_ms=m_timed.get("plain_ms"),
             bound_ms=m_timed["bound_ms"], bound_by=m_timed["bound_by"],
             library_ms=m_timed.get("library_ms")),
    ]
    report["kernels"] = kernels
    if args.report:
        Path(args.report).parent.mkdir(parents=True, exist_ok=True)
        Path(args.report).write_text(json.dumps(report, indent=1))
    if rehearse:
        log("rehearsal finished (CPU, toy sizes): no result")
        return 3
    log(smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
