#!/usr/bin/env python3
"""Drive the PyTorch port's bi-metric query path on one NVIDIA GPU.

    python3 chip_smoke.py [--n 171332] [--report PATH]

Phases (any failure exits nonzero and prints no result line):

1. environment and build: the card's name and power limit, the torch
   version, and the nvcc build of every ``src/repro_torch/kernels/csrc/*.cu``
   (cached under ``build/``);
2. each hand-written kernel against its plain PyTorch version on the card, at
   the slice's shapes, with median times (CUDA events), bounds and yardsticks;
   the merge also on rows the engine never makes (unsorted pool, NaN, signed
   zeros, K > P), bit for bit; beside the eager times (``ms``), the device's
   time alone by CUDA-graph replay (``device_ms``): for the gathers over a
   rotation of id sets whose rows exceed the L2 cache, so they come from
   HBM as in a search;
3. cross-check of the whole slice at N=8192 (dims 384/4096): the same graph
   searched on the card and with ``device="cpu"``, and two N=2048 builds
   from one initial graph;
4. the full slice: ``make_dataset`` at the TREC-COVID corpus size, Vamana
   build with the paper's DiskANN parameters, ``bimetric_search`` and
   ``rerank_search`` at Q in {100, 1000}, recall@10 / nDCG@10 against the
   brute-force top-10 under D;
5. the sharded slice on phase 4's data and graph: S corpus blocks on the
   one card (``search_mesh(S, devices=["cuda:0"] * S)``), ``vamana.search``
   and ``bimetric_search`` at S=4 (and S=3, one pad row), each bit-equal to
   its shards=1 run and launching ``gather_score_local`` S times a wave;
6. the kernels off the search path, through ``ops.flash_attention``,
   ``ops.flash_decode`` and ``ops.embedding_bag``: each against its plain
   version at the JAX sweep shapes and the edge cases, then once at the
   full widths of the configurations it serves (sfr-mistral-7b and
   bge-micro-like attention layers, decode at a 32k cache at batch 8 and,
   full, at batch 1, DIN's bag), with
   times beside the bound, the plain version and the library call; the
   16-bit attention rows must launch the tensor-core route, the f32 rows the
   SIMT one. The bag is also checked at every row width and dtype, with its
   bags split over several warps and not, on tables whose base is not
   16-byte aligned, and with an id past the table (NaN); its timed rows
   print the kernel's plan and the device time by CUDA-graph replay;
7. the cover-tree slice (the paper's second instantiation), on phase 4's
   data: first at N=2048 (dims 384/4096) the tree built on the card must
   equal the one built with ``device="cpu"``, and the descent on the card
   the CPU descent and the NumPy oracle's D-call counts, near-ties aside;
   then the tree built on the card from phase 4's ``corpus_d`` (T=3),
   flattened, and searched under D at each Q (``search_corpus`` and
   ``bimetric_search``), beside phase 4's bi-metric DiskANN runs; both
   again at S=4 shards on the one card (a ``beam.ShardedStepper`` steps
   the descent; the waves are scored on the whole corpus), bit-equal to
   shards=1;
8. the towers: ``cheap_tower()`` (f32) and ``expensive_tower()`` (bf16,
   all 32 layers) drawn on the card from seeds; (a) each tower's attention
   at its batch shape through ``layers.blockwise_attention`` against the
   plain version (the D tower's on the tensor-core route, the d tower's on
   the SIMT one), with the kernel's time and that of the GQA repeat and
   transposes around it; (b) each tower on the card against its copy on
   the CPU (D cut to its first 2 layers); (c) the path of
   ``launch/serve.py``: 2,048 docs of 256 tokens and 64 queries of 32
   embedded by both towers through ``EmbedTower`` at batch 64, the graph
   built on d, ``bimetric_search`` and ``rerank_search`` under D at
   Q in {50, 200}, with tokens/s, D's TFLOP/s against its bound, and peak
   memory;
9. the serving engine, ``BiMetricEngine`` on phase 8's towers and docs,
   with 64 queries of the docs' length (a doc with its first half redrawn)
   at Q alternating 50 and 200, 16 slots: (a) each tower's embedding of a
   row bit-equal across batch compositions; (b) the sync drive from an
   empty doc cache, with requests/s, D batches, docs a batch, D's share
   and recall@10 under D; (c) the async slot drive (mixed priorities) from
   an empty cache, bit-equal to (b), with latency percentiles; (d) on the
   warm cache, transient drain faults (bit-equal, retried) and a
   persistent outage under ``degrade`` (each answer its stage-1 proxy
   ranking); (e) a cover-tree engine, sync = async; (f) the re-rank
   baseline; the kernels' launches counted over (b)-(f); (g) one stage-2
   slot wave (B=16, dim 4096) against the plain gather and merge; (h) the
   engine at ``shards=4`` (``dedup`` auto and bitmap) and 3 on one card,
   the cover-tree engine at 4 and (d)'s transient faults at 4, each warm
   from (b)'s D cache, sync and async bit-equal to (b) / (e), with the
   shard-local gather launched S times a stage-1 wave; after its counts,
   the stage-1 wave at B=16 and B=64 held shard by shard (S=4 and 3)
   against the plain local gather, the shards' sum against the gather;
10. scatter-gather search over per-shard sub-indices
   (``core/distributed.py``): at phase 3's size, four graphs built on the
   card by ``build_sharded`` searched on the card and on the CPU (each
   shard's answer equal up to a near-tie); then on phase 4's data, S=4
   graphs of N/4 rows built on d on ``["cuda:0"] * 4`` (timed),
   ``sharded_bimetric_search`` at each Q beside phase 4's bi-metric recall,
   ``gather_score`` and the merge launched and the local gather not; each
   shard within max(k, Q // 4) D calls; the ring matmuls against one dense
   ``torch.matmul``;
11. training the d tower: ``cheap_tower()`` at full width from a seed,
   InfoNCE at temperature 0.2 on ``contrastive_batch_fn(64, 256,
   32768)`` (at the default 0.05 a random tower's loss, ~4e-6, is below
   what f32 logits near 20 resolve), 30 ``Trainer`` steps (AdamW lr 1e-3,
   warmup 20) on the card through the forward and
   the backward ``flash_attention`` kernels, both counted (the backward by
   route: d's f32 heads of 64 take the 3xTF32 one); the loss curve,
   step ms, tokens/s, the forward / backward / optimizer split and peak
   memory; the losses finite and falling (mean of the last 5 below the
   first 5); then 4 steps at ``grad_accum=2`` against a ``grad_accum=1``
   run of the two halves' mean loss (InfoNCE's negatives are in-batch, so
   a micro-batch's loss is its own); after the path, the backward kernel
   against its plain version at d's and D's layer shapes and the edges
   (non-causal Sq < Skv, Sq > Skv with empty rows, dv != dh, f16, 32-row
   tiles, each route's tile edges, heads left to the SIMT kernel), each on
   the route ``_backward_route`` picks, given the forward's log-sum-exp;
   the two layers timed (eager, graph replay, the profiler's split) beside
   the bound of the route's operations, the SIMT kernel on the same
   inputs, the plain version and SDPA's backward timed alone.

Phases 6, 8 and 9 run under ``torch.inference_mode()`` (serving records
no autograd graph); ``flash_decode`` and ``embedding_bag`` have no backward
and refuse an input that requires grad.

Ends with a JSON line of every ported kernel and the result line
``{"ok": true, "device": {...}}``. Needs one CUDA device; imports no JAX.
``--rehearse`` runs the control flow on the CPU at toy sizes and exits 3.
"""
from __future__ import annotations

import argparse
import functools
import itertools
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): HBM rate, f32 rate outside the tensor
# cores (the kernels here do f32 scalar arithmetic), and the dense bf16
# tensor-core rate, the least time for bf16 attention whatever a kernel uses
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
TF32_OPS_PER_S = 495e12  # dense TF32 tensor-core rate

CROSS_RTOL = 1e-5  # near-tie allowance between the card and the CPU
L2_BYTES = 50e6  # the H100's L2 cache

# cluster size of the generator's defaults (n=4096, n_clusters=64): kept as
# N grows, so the D-neighbourhoods stay as local as at the default size
POINTS_PER_CLUSTER = 64


def require(cond, msg="check failed"):
    """A check that holds under ``python -O`` too."""
    if not cond:
        raise AssertionError(msg)


def log(*a):
    print(*a, flush=True)


def time_ms(fn, reps=11, inner=10, warmup=3, spread=False):
    """Per-call device time of ``fn`` (ms): the median over ``reps`` CUDA-event
    windows of ``inner`` back-to-back calls each, so the host's launch work
    overlaps the device's instead of being counted. ``spread``: (median,
    min, max) of the windows."""
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
    if spread:
        return statistics.median(times), min(times), max(times)
    return statistics.median(times)


def time_graph_ms(fn, reps=11, inner=10):
    """Per-call device time of ``fn`` (ms) with the host's launch work taken
    out: ``inner`` calls captured once in a CUDA graph, the graph replayed
    between CUDA events, the median over ``reps``. For calls that take the
    host longer to launch than the device to run, where :func:`time_ms`
    measures the host."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / inner)
    del graph
    return statistics.median(times)


def time_cold_ms(fn, g, dev, n, b, k, set_bytes):
    """Device time of ``fn(ids)`` (ms, :func:`time_graph_ms`) over a rotation
    of (b, k) id sets drawn from all n corpus rows, enough sets that more
    than twice the L2 cache's bytes of rows pass between two uses of one
    set: each call reads its rows from HBM, as a search's waves do.
    ``set_bytes`` is the bytes of rows one call reads. The rows a call can
    read must also exceed the L2 by far: the local gather at dim 384 reads
    one shard's rows (66 MB at S=4, 1.3x the L2), sets repeat them, and part
    of its time is L2 reads, so its ``device_ms`` is below a cold one."""
    count = max(2, math.ceil(2 * L2_BYTES / set_bytes) + 1)
    sets = [torch.randint(0, n, (b, k), generator=g, device=dev,
                          dtype=torch.int32) for _ in range(count)]
    it = itertools.cycle(sets)
    # a whole number of rotations per replay, so no set follows itself
    return time_graph_ms(lambda: fn(next(it)),
                         inner=count * max(1, 10 // count))


def bound(nbytes, nops, ops_per_s=F32_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / ops_per_s * 1e3
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
                # ms: eager on one id set, as every kernel's ms, so its rows
                # may come from L2; device_ms: HBM-cold by graph replay
                row["ms"] = time_ms(lambda: l2_topk.gather_score(
                    corpus, qt, live, metric="l2"))
                row["plain_ms"] = time_ms(lambda: l2_topk.gather_score_plain(
                    corpus, qt, live, metric="l2"), reps=5, inner=2)
                row["device_ms"] = time_cold_ms(
                    lambda ids: l2_topk.gather_score(corpus, qt, ids,
                                                     metric="l2"),
                    g, dev, n, tb, tk, tb * tk * dim * 4)
            rows_out.append(row)
            if timed is None and dim == max(dims):
                timed = row  # the stage-2 wave
        del corpus, views
    return max_err, rows_out, timed


def check_gather_local(dev, n, dims, ks, b, timing, rehearse):
    """gather_score_local against its plain version at the offset of every
    shard of S=4 and of the uneven S=3 split of N, in every form and row
    type, at every wave width K of the main path, with lanes that mix
    owned, foreign and padding ids. Foreign and
    padding lanes must be +0.0 exactly, owned lanes must equal the
    gather_score kernel's bit for bit, and so must the shards' sum. Times
    one launch per shard at the S=4 waves of the main path."""
    from repro_torch.distributed import sharding
    from repro_torch.kernels import backend, l2_topk

    g = torch.Generator(device=dev).manual_seed(13)
    max_err, rows_out, timed = 0.0, [], None
    for dim in dims:
        corpus = torch.randn(n, dim, generator=g, device=dev)
        corpus[7] = 0.0
        q = torch.randn(b, dim, generator=g, device=dev)
        waves = []
        for k in ks:
            ids = torch.randint(-1, n, (b, k), generator=g, device=dev,
                                dtype=torch.int32)
            ids[:, ::9] = -1  # padding lanes
            ids[:, 1] = 7  # the zero row
            waves.append(ids)
        views = {"f32": backend.as_corpus_view(corpus)}
        for mode in ("int8", "fp8", "fp8_e5m2"):
            views[mode] = backend.as_corpus_view(corpus, quantize=mode)
        for name, view in views.items():
            meta = l2_topk.pack_row_meta(view)
            forms = [(False, None if name == "f32" else meta), (True, meta)]
            tol = 1e-5 if name == "f32" else 1e-4
            for shards in (4, 3):
                st = sharding.shard_corpus_view(view, shards)
                n_local = st[-1]
                blocks = []
                for s in range(shards):
                    bv = backend.CorpusView(
                        rows=st[0][s], sq_norms=st[1][s], inv_norms=st[2][s],
                        scales=st[3][s] if view.scales is not None else None,
                        zero_points=(st[4][s] if view.zero_points is not None
                                     else None))
                    blocks.append((bv.rows, l2_topk.pack_row_meta(bv)))
                for metric, ids in itertools.product(l2_topk.VALID_METRICS,
                                                     waves):
                    scale = _term_scale(view, q, ids, metric)
                    for mm, m in forms:
                        full = l2_topk.gather_score(view.rows, q, ids,
                                                    metric=metric, meta=m,
                                                    matmul=mm)
                        total = None
                        for s, (r, bm) in enumerate(blocks):
                            off = s * n_local
                            bm = bm if m is not None else None
                            got = l2_topk.gather_score_local(
                                r, q, ids, off, metric=metric, meta=bm,
                                matmul=mm)
                            want = l2_topk.gather_score_local_plain(
                                r, q, ids, off, metric=metric, meta=bm,
                                matmul=mm)
                            owned = (ids >= 0) & (ids - off >= 0) & (
                                ids - off < n_local)
                            where = (f"local {dim} K={ids.shape[1]} S={shards} "
                                     f"s={s} {metric} {name} mm={mm}")
                            require(bool((got[~owned].view(torch.int32) == 0)
                                         .all()), f"{where}: foreign lane")
                            require(torch.equal(got[owned], full[owned]),
                                    f"{where}: owned lane != gather_score")
                            err = (got[owned] - want[owned]).abs()
                            lim = tol * torch.maximum(want[owned].abs(),
                                                      scale[owned])
                            require(bool((err <= lim).all()),
                                    f"{where}: max err {float(err.max()):.3e}")
                            if err.numel():
                                max_err = max(max_err, float(err.max()))
                            total = got if total is None else total + got
                        total = torch.where(ids >= 0, total, torch.inf)
                        require(torch.equal(total, full),
                                f"local {dim} K={ids.shape[1]} S={shards} "
                                f"{metric} {name} mm={mm}: shard sum != "
                                "gather_score")
                del st, blocks
        # times at the main path's shapes and form (gather-then-reduce over
        # f32 rows, S=4 blocks, live ids drawn from the whole corpus): one
        # launch per shard, averaged over the four shards of a wave
        for tb, tk in timing.get(dim, ()):
            qt = torch.randn(tb, dim, generator=g, device=dev)
            live = torch.randint(0, n, (tb, tk), generator=g, device=dev,
                                 dtype=torch.int32)
            stacked, n_local = sharding.shard_corpus(corpus, 4)
            row = dict(dim=dim, B=tb, K=tk, S=4)
            per = []
            for s in range(4):
                off = s * n_local
                owned = int(((live >= off) & (live < off + n_local)).sum())
                nbytes = owned * dim * 4 + tb * dim * 4 + 2 * tb * tk * 4
                cell = dict(owned_lanes=owned)
                cell["bound_ms"], cell["bound_by"] = bound(nbytes,
                                                           3 * owned * dim)
                blk = stacked[s]
                if not rehearse:
                    cell["ms"] = time_ms(lambda: l2_topk.gather_score_local(
                        blk, qt, live, off, metric="l2"))
                    cell["plain_ms"] = time_ms(
                        lambda: l2_topk.gather_score_local_plain(
                            blk, qt, live, off, metric="l2"), reps=5, inner=2)
                    cell["device_ms"] = time_cold_ms(
                        lambda ids: l2_topk.gather_score_local(
                            blk, qt, ids, off, metric="l2"),
                        g, dev, n, tb, tk, owned * dim * 4)
                per.append(cell)
            for key in ("owned_lanes", "bound_ms", "ms", "plain_ms",
                        "device_ms"):
                if key in per[0]:
                    row[key] = statistics.fmean(c[key] for c in per)
            row["bound_by"] = per[0]["bound_by"]
            row["per_shard"] = per
            rows_out.append(row)
            if dim == max(dims):
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


def _bit_equal(a, b):
    """torch.equal, with f32 compared bit for bit (NaN equals its own copy,
    -0.0 differs from +0.0)."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def _merge_edges(dev, g):
    """Rows the engine never hands in: an unsorted pool, NaN and -0.0/+0.0
    distances in both runs, K > P, and P + K that is no power of two.
    Each is (pool ids, dists, flags, candidate ids, dists)."""
    cases = []
    for b, p, k in ((5, 100, 37), (3, 20, 77), (4, 256, 64), (2, 1, 1)):
        pi, pd, pf, ci, cd = _merge_inputs(dev, b, p, k, g)
        cases.append((pi, pd, pf, ci, cd))  # sorted pool
        perm = torch.argsort(torch.rand(b, p, generator=g, device=dev), 1)
        cases.append((pi.gather(1, perm), pd.gather(1, perm),
                      pf.gather(1, perm), ci, cd))  # unsorted pool
        # NaN and signed zeros: a sorted pool (NaN last) and an unsorted one
        zd = pd.clone()
        zd[:, : p // 3] = -0.0
        zd[:, p // 3: 2 * p // 3] = 0.0
        zd[:, -1:] = float("nan")
        zc = cd.clone()
        zc[:, ::3] = -0.0
        zc[:, 2::7] = 0.0
        zc[:, ::5] = float("nan")  # with P = 1, NaN meets NaN
        cases.append((pi, zd, pf, ci, zc))
        cases.append((pi.flip(1), zd.flip(1), pf.flip(1), ci, zc))
    return cases


def check_merge(dev, shapes, rehearse):
    from repro_torch.kernels import l2_topk, ref

    g = torch.Generator(device=dev).manual_seed(12)
    for i, (pi, pd, pf, ci, cd) in enumerate(_merge_edges(dev, g)):
        got = l2_topk.merge_pool_batch(pi, pd, pf, ci, cd)
        want = ref.merge_pool_batch_ref(pi, pd, pf, ci, cd)
        for name, x, y in zip(("ids", "dists", "flags"), got, want):
            require(_bit_equal(x, y), f"merge edge case {i} "
                    f"(P={pi.shape[1]}, K={ci.shape[1]}) {name} differs")
        got = l2_topk.beam_merge_topk(pi, pd, ci, cd)
        want = ref.beam_merge_topk_ref(pi, pd, ci, cd)
        require(_bit_equal(got[0], want[0]) and _bit_equal(got[1], want[1]),
                f"beam_merge_topk edge case {i} differs")
    rows_out, timed = [], None
    for b, p, k in shapes:
        pi, pd, pf, ci, cd = _merge_inputs(dev, b, p, k, g)
        got = l2_topk.merge_pool_batch(pi, pd, pf, ci, cd)
        want = ref.merge_pool_batch_ref(pi, pd, pf, ci, cd)
        for name, x, y in zip(("ids", "dists", "flags"), got, want):
            require(torch.equal(x, y), f"merge ({p},{k}) {name} differs")
        require(torch.equal(got[0][0], pi[0]) and torch.equal(got[2][0], pf[0]))
        # the function's bytes: each row's ids, dists and flags read once,
        # P of each written; the work of any one sort is not the function's
        nbytes = b * (p + k) * 8 + b * p + b * p * 9
        row = dict(P=p, K=k, B=b)
        row["bound_ms"], row["bound_by"] = bound(nbytes, 0)
        if not rehearse:
            # ms, plain_ms, library_ms: as the engine calls them, one eager
            # call after another (at these shapes the host's launch work is
            # most of it); device_ms, library_device_ms: the device's time
            # alone, by CUDA-graph replay
            merge = lambda: l2_topk.merge_pool_batch(pi, pd, pf, ci, cd)
            cat = torch.cat([pd, cd], dim=1)
            lib = lambda: torch.sort(cat, dim=1, stable=True)
            row["ms"] = time_ms(merge)
            row["plain_ms"] = time_ms(lambda: ref.merge_pool_batch_ref(
                pi, pd, pf, ci, cd))
            row["library_ms"] = time_ms(lib)
            row["device_ms"] = time_graph_ms(merge)
            row["library_device_ms"] = time_graph_ms(lib)
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
    runs, results = [], {}
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
            results[method, q] = res
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
    # the kernels of this path: the unsharded gather and the merge
    require(launches["gather_score_local"] == 0)
    if not rehearse:
        for name in ("gather_score", "beam_merge_topk"):
            require(launches[name] > 0,
                    f"{name} was never launched on the main path")
    return out, dict(data=data, idx=idx, k=k, true_ids=true_ids,
                     results=results)


# --------------------------------------------------------------------------
# phase 5: the sharded slice
# --------------------------------------------------------------------------
def sharded_slice(dev, ph4, quotas, rehearse):
    """Phase 4's data and graph searched with the corpus split into S
    blocks on one device: ``vamana.search(shards=4)``, ``bimetric_search(
    shards=4)`` at every Q, S=3 (one pad row) at the smallest Q, and the
    norm-cache form with int8 stage-1 residency at S=4. Each run must equal
    its shards=1 run bit for bit and launch gather_score_local S times a
    wave."""
    from repro_torch.core import bimetric, distances, metrics, vamana
    from repro_torch.distributed import sharding
    from repro_torch.kernels import l2_topk

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    data, idx, k = ph4["data"], ph4["idx"], ph4["k"]
    n = data.corpus_d.shape[0]
    n_queries = data.queries_d.shape[0]
    corpora = (data.corpus_d, data.corpus_D)
    q0 = min(quotas)
    one = torch.device("cuda", 0) if dev.type == "cuda" else dev
    mesh = {s: sharding.search_mesh(s, devices=[one] * s) for s in (3, 4)}

    def vamana_run(**kw):
        ids, dists, calls = vamana.search(idx, data.corpus_d, data.queries_d,
                                          k=k, device=dev, **kw)
        return dict(ids=ids, dists=dists, calls=calls)

    def bimetric_run(q, fns=(None, None), **kw):
        res = bimetric.bimetric_search(
            *fns, idx, data.queries_d, data.queries_D, n_points=n, quota=q,
            k=k, corpora=corpora, device=dev, **kw)
        return res._asdict()

    def timed(fn):
        t0 = time.perf_counter()
        res = fn()
        sync()
        return res, time.perf_counter() - t0

    # (name, S, Q, its shards=1 run, the sharded run); the unsharded
    # bi-metric run scores through the metric callables, as phase 4 does
    fns = (distances.EmbeddingMetric(data.corpus_d).dists_batch,
           distances.EmbeddingMetric(data.corpus_D).dists_batch)
    mm = dict(backend="matmul", quantize="int8")
    specs = [("vamana", 4, None, vamana_run,
              lambda: vamana_run(shards=4, mesh=mesh[4]))]
    specs += [(f"bimetric Q={q}", 4, q, lambda q=q: bimetric_run(q, fns),
               lambda q=q: bimetric_run(q, shards=4, mesh=mesh[4]))
              for q in quotas]
    specs += [(f"bimetric Q={q0}", 3, q0, lambda: bimetric_run(q0, fns),
               lambda: bimetric_run(q0, shards=3, mesh=mesh[3]))]
    specs += [("matmul-int8", 4, q0, lambda: bimetric_run(q0, **mm),
               lambda: bimetric_run(q0, shards=4, mesh=mesh[4], **mm))]

    # the shards=1 runs first, timed; they must repeat phase 4 exactly
    base = []
    for name, shards, q, base_fn, _ in specs:
        res, dt = timed(base_fn)
        if name.startswith("bimetric"):
            for field, want in ph4["results"]["bimetric", q]._asdict().items():
                require(torch.equal(res[field], want),
                        f"{name}: {field} differs from phase 4")
        base.append((res, dt))
        log(f"  {name:15s} S=1: {dt:.4f} s, {n_queries / dt:.2f} q/s")

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    l2_topk.reset_launches()  # the sharded path starts here
    runs = []
    for (name, shards, q, _, fn), (want, base_s) in zip(specs, base):
        before = dict(l2_topk.launches)
        res, dt = timed(fn)
        delta = {kk: l2_topk.launches[kk] - before[kk] for kk in before}
        for field, w in want.items():
            require(torch.equal(res[field], w),
                    f"{name} S={shards}: {field} differs from shards=1")
        run = dict(run=name, S=shards, Q=q, query_s=dt, qps=n_queries / dt,
                   shards1_query_s=base_s, launches=delta)
        if q is not None:
            require(int(res["D_calls"].max()) <= q, (name, shards))
            run["recall_at_10"] = float(metrics.recall_at_k(
                res["ids"], ph4["true_ids"]).mean())
            run["mean_D_calls"] = float(res["D_calls"].float().mean())
        waves = delta["beam_merge_topk"]
        if not rehearse:
            require(waves > 0 and delta["gather_score"] == 0
                    and delta["gather_score_local"] == shards * waves,
                    f"{name} S={shards}: launches {delta}")
        log(f"  {name:15s} S={shards}: {dt:.4f} s, {run['qps']:.2f} q/s "
            f"({dt / base_s:.3f}x shards=1), launches {delta}, bit-equal "
            "to shards=1")
        runs.append(run)
    launches = dict(l2_topk.launches)  # read just after the sharded path
    out = dict(runs=runs, launches=launches)
    if dev.type == "cuda":
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        log(f"  max_memory_allocated {out['max_memory_allocated']} bytes")
    if not rehearse:
        require(launches["gather_score_local"] > 0,
                "gather_score_local was never launched on the sharded path")
    return out


# --------------------------------------------------------------------------
# phase 6: the kernels off the search path
# --------------------------------------------------------------------------
F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16
# the JAX kernel tests' tolerances (assert_allclose with atol = rtol = tol),
# for the check shapes, whose outputs are about 0.2; f16 within its own
# rounding (the port's card tests)
ATTN_TOL = {F32: 2e-5, BF16: 2e-2, F16: 2e-3}
BAG_TOL = {F32: 1e-5, BF16: 2e-2, F16: 2e-3}
# (atol, rtol) of the full-width rows. An attention output there averages
# thousands of keys and is about 0.01 to 0.03, so a bf16 atol of 2e-2 would
# pass a wrong kernel: the limit is scaled to the data instead, and rtol
# 1e-2 still covers one bf16 ulp of the rounded output (at most 2^-7 of it)
MAIN_TOL = {F32: (2e-5, 2e-5), BF16: (1e-3, 1e-2)}

# check shapes: the JAX sweeps (tests/test_kernels.py), bf16, dv != dh
# (DeepSeek-V3's MLA 192/128 included) and Sq > Skv causal (empty rows);
# then the tensor-core route's edges in bf16 and f16: lengths that are no
# multiple of 64 or 128, Sq > Skv, non-causal, 192/128, 256, a head of 24
# (padded to 64 by the copy) and the smoke configs' 16 and 8, a 20-wide
# head (no multiple of 8: the SIMT route)
ATTN_CHECKS = [  # B, H, Sq, Skv, dh, dv, causal, dtype
    (2, 4, 128, 128, 64, 64, True, F32), (1, 2, 96, 96, 32, 32, True, F32),
    (2, 2, 64, 256, 32, 32, False, F32), (1, 1, 128, 128, 128, 128, True, BF16),
    (1, 2, 33, 65, 16, 16, True, F32), (1, 2, 64, 64, 48, 32, True, F32),
    (2, 4, 128, 128, 64, 64, True, BF16), (1, 2, 70, 70, 192, 128, True, F32),
    (1, 2, 70, 70, 192, 128, True, BF16), (2, 1, 100, 37, 64, 64, True, F32),
    (2, 3, 70, 70, 128, 128, True, BF16), (2, 3, 70, 70, 128, 128, True, F16),
    (2, 1, 100, 37, 128, 128, True, BF16), (2, 1, 300, 37, 64, 64, True, F16),
    (1, 2, 100, 37, 64, 64, False, BF16), (1, 2, 200, 333, 128, 128, False, F16),
    (1, 2, 300, 300, 192, 128, True, F16), (1, 2, 300, 300, 256, 256, True, BF16),
    (1, 2, 150, 200, 256, 256, False, F16), (2, 2, 257, 257, 24, 24, True, BF16),
    (1, 2, 130, 130, 16, 16, True, BF16), (1, 2, 77, 77, 8, 8, True, F16),
    (1, 2, 70, 70, 20, 20, True, BF16), (1, 2, 129, 200, 256, 256, True, F32),
    # more (head, query tile) items than SMs: blocks walk several
    (4, 8, 600, 400, 64, 64, False, BF16), (4, 8, 600, 400, 64, 64, True, F16),
]
# B, H, S, dh, dv, dtype, lengths (None: seeded in [1, S]); S = 1000 and 333
# are multiples of no tile
DECODE_CHECKS = [
    (2, 4, 256, 64, 64, F32, None), (1, 2, 100, 32, 32, F32, None),
    (3, 1, 512, 128, 128, F32, None), (3, 2, 1000, 128, 128, F32, (0, 1, 1000)),
    (3, 2, 1000, 128, 128, BF16, (0, 1, 1000)),
    (3, 2, 333, 192, 128, BF16, (0, 1, 333)),
]
# the split-KV grid's edges (B, H, S, dh, dv, dtype): each row of a case
# takes one of the lengths 0, 1, chunk - 1, chunk, chunk + 1, S and past S
# (decode_split's chunk for S and B*H); S below one chunk and S no multiple
# of it, B*H = 1 and B*H past 132, 1024-key chunks (B*H = 256, S = 8193), the
# vector path (rows of 16-byte multiples: 24/40 too) and the scalar one
# (18/30)
DECODE_EDGES = [
    (7, 2, 1000, 128, 128, BF16), (7, 2, 1000, 24, 40, F16),
    (7, 2, 1000, 18, 30, F32), (7, 2, 1000, 192, 128, F32),
    (2, 1, 40, 64, 64, BF16), (1, 1, 777, 128, 128, F32),
    (8, 20, 700, 64, 64, BF16), (8, 32, 8193, 16, 16, F16),
]
# V, D, B, L, dtype, the table's base in elements past an aligned one: the
# JAX sweep's shapes; then every width from one element to five column chunks
# (D = 10 xDeepFM's, 18 DIN's, 129 f32 past 32 loads a row) in each dtype,
# with bags split over four warps (B = 512) and one warp a bag (B = 4096);
# then views whose base is not 16-byte aligned: one row in (DIN's table
# sliced as big[1:]) and one element in, where the loads narrow to an element
BAG_CHECKS = [(200, 32, 8, 10, F32, 0), (64, 128, 4, 5, F32, 0),
              (1000, 16, 16, 30, F32, 0)]
BAG_CHECKS += [(5000, d, b, l, dt, 0) for d in (1, 10, 18, 40, 64, 129)
               for dt in (F32, BF16, F16) for b, l in ((512, 100), (4096, 45))]
BAG_CHECKS += [(5000, 18, 37, 45, F32, 18), (5000, 1, 37, 45, F32, 1),
               (5000, 18, 512, 100, F16, 1), (5000, 40, 4096, 45, BF16, 1),
               (5000, 64, 512, 100, F32, 1)]


def _ops_rate(dtype):
    """Peak rate for the inputs' type: the dense tensor-core rate for bf16
    and f16, the f32 rate outside the tensor cores for f32."""
    return BF16_OPS_PER_S if dtype in (BF16, F16) else F32_OPS_PER_S


def _agree(got, want, tol, what, rtol=None):
    """|got - want| <= tol + rtol * |want| everywhere (rtol defaults to tol);
    returns the max error."""
    rtol = tol if rtol is None else rtol
    g, w = got.float(), want.float()
    require(g.shape == w.shape and bool(torch.isfinite(g).all()),
            f"{what}: shape {tuple(g.shape)} or non-finite values")
    err = (g - w).abs()
    require(bool((err <= tol + rtol * w.abs()).all()),
            f"{what}: max err {float(err.max()):.3e}")
    return float(err.max()) if err.numel() else 0.0


def _attn_inputs(g, dev, b, h, sq, skv, dh, dv, dtype):
    return [torch.randn(*s, generator=g, device=dev).to(dtype)
            for s in ((b, h, sq, dh), (b, h, skv, dh), (b, h, skv, dv))]


def _decode_inputs(g, dev, b, h, s, dh, dv, dtype):
    return (torch.randn(b, h, dh, generator=g, device=dev, dtype=dtype),
            torch.randn(b, s, h, dh, generator=g, device=dev, dtype=dtype),
            torch.randn(b, s, h, dv, generator=g, device=dev, dtype=dtype))


def _bag_ids(g, dev, v, b, l):
    """Bag lengths seeded in [0, L], the rest -1; bag 0 is all pads."""
    idx = torch.randint(0, v, (b, l), generator=g, device=dev,
                        dtype=torch.int32)
    n = torch.randint(0, l + 1, (b,), generator=g, device=dev)
    n[0] = 0
    idx[torch.arange(l, device=dev)[None, :] >= n[:, None]] = -1
    return idx


def check_off_path(dev, big_v):
    """Each kernel against its plain version at the check shapes, through
    the ops entry points; returns the max error per kernel."""
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    require(not torch.backends.cuda.matmul.allow_tf32,
            "the plain versions' f32 products must not run in TF32")
    g = torch.Generator(device=dev).manual_seed(16)
    errs = dict(flash_attention=0.0, flash_decode=0.0, embedding_bag=0.0)
    for b, h, sq, skv, dh, dv, causal, dt in ATTN_CHECKS:
        q, k, v = _attn_inputs(g, dev, b, h, sq, skv, dh, dv, dt)
        route = f"flash_attention_{fa._attention_route(dt, dh, dv)}"
        before = fa.launches[route]
        got = ops.flash_attention(q, k, v, causal=causal)
        want = fa.flash_attention_plain(q, k, v, causal=causal)
        what = f"flash_attention {(b, h, sq, skv, dh, dv, causal, dt)}"
        require(dev.type != "cuda" or fa.launches[route] == before + 1,
                f"{what}: did not launch {route}")
        errs["flash_attention"] = max(errs["flash_attention"], _agree(
            got, want, ATTN_TOL[dt], what))
        require(got.dtype == dt, f"{what}: dtype {got.dtype}")
        if causal and sq > skv:
            require(bool((got[:, :, : sq - skv] == 0).all()),
                    f"{what}: empty rows are not 0")
    for b, h, s, dh, dv, dt, lens in DECODE_CHECKS:
        q, k, v = _decode_inputs(g, dev, b, h, s, dh, dv, dt)
        length = (torch.randint(1, s + 1, (b,), generator=g, device=dev)
                  if lens is None else torch.tensor(lens, device=dev))
        got = ops.flash_decode(q, k, v, length=length)
        want = fa.flash_decode_plain(q, k, v, length=length)
        what = f"flash_decode {(b, h, s, dh, dv, dt, lens)}"
        errs["flash_decode"] = max(errs["flash_decode"], _agree(
            got, want, ATTN_TOL[dt], what))
        if lens is not None:
            require(bool((got[0] == 0).all()), f"{what}: length 0 is not 0")
    for b, h, s, dh, dv, dt in DECODE_EDGES:
        q, k, v = _decode_inputs(g, dev, b, h, s, dh, dv, dt)
        c = fa.decode_split(s, b * h)[0]
        edges = [0, 1, c - 1, c, c + 1, s, s + 7]
        lens = [edges[(i + 6) % len(edges)] for i in range(b)]
        what = f"flash_decode edge {(b, h, s, dh, dv, dt)} chunk {c}"
        outs = []
        for length in (torch.tensor(lens, device=dev, dtype=torch.int32),
                       c + 1):
            before = fa.launches["flash_decode"]
            outs.append(ops.flash_decode(q, k, v, length=length))
            require(dev.type != "cuda"
                    or fa.launches["flash_decode"] == before + 1,
                    f"{what}: not one launch per call")
            want = fa.flash_decode_plain(q, k, v, length=length)
            errs["flash_decode"] = max(errs["flash_decode"], _agree(
                outs[-1], want, ATTN_TOL[dt], f"{what} length {length}"))
        empty = torch.tensor(lens, device=dev) == 0
        require(bool((outs[0][empty] == 0).all()),
                f"{what} lens {lens}: length 0 is not 0")
    bags = [(v, d, b, l, dt, off, torch.randint(
        -1, v, (b, l), generator=g, device=dev, dtype=torch.int32))
        for v, d, b, l, dt, off in BAG_CHECKS]
    bags += [(v, d, b, l, F32, 0, _bag_ids(g, dev, v, b, l))
             for v, d, b, l in ((big_v, 18, 512, 100), (big_v, 18, 70, 33))]
    for v, d, b, l, dt, off, idx in bags:
        flat = torch.randn(v * d + off, generator=g, device=dev).to(dt)
        table = flat[off:].view(v, d)
        idx[1] = -1  # an all-pad bag in every case
        plan = eb.table_plan(table, idx)
        for mode in ("sum", "mean"):
            before = eb.launches["embedding_bag"]
            got = ops.embedding_bag(table, idx, mode=mode)
            what = (f"embedding_bag V={v} D={d} B={b} L={l} {dt} base "
                    f"+{off} {mode} {plan}")
            require(dev.type != "cuda"
                    or eb.launches["embedding_bag"] == before + 1,
                    f"{what}: not one launch per call")
            want = eb.embedding_bag_plain(table, idx, mode=mode)
            errs["embedding_bag"] = max(errs["embedding_bag"], _agree(
                got, want, BAG_TOL[dt], what))
            require(bool((got[1] == 0).all()), f"{what}: all-pad bag")
            require(torch.equal(ops.embedding_bag(table, idx, mode=mode), got),
                    f"{what}: two calls differ")
    if dev.type != "cuda":  # the plain version raises on an id >= V
        return errs
    # an id past the table makes its bag NaN, in any warp's slice of it
    idx = _bag_ids(g, dev, big_v, 8, 100)
    table = torch.randn(big_v, 18, generator=g, device=dev)
    want = eb.embedding_bag_plain(table, idx)
    idx[2, 0], idx[3, 99] = big_v, big_v + 7
    got = ops.embedding_bag(table, idx)
    require(bool(torch.isnan(got[2:4]).all()), "embedding_bag: an id >= V "
            "does not give NaN")
    keep = [0, 1, 4, 5, 6, 7]
    errs["embedding_bag"] = max(errs["embedding_bag"], _agree(
        got[keep], want[keep], BAG_TOL[F32], "embedding_bag, the other bags "
        "beside an id >= V"))
    return errs


def off_path(dev, sizes, rehearse):
    """Phase 6's path: each ops entry point at the full widths of the
    configurations it serves, launches counted from 0; each output held
    against the plain version; then each timed beside its bound, its plain
    version and the one library call that computes the same function."""
    import torch.nn.functional as F

    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    g = torch.Generator(device=dev).manual_seed(17)
    cases = []
    for role, b, h, s, d, dt in sizes["attn"]:
        q, k, v = _attn_inputs(g, dev, b, h, s, s, d, d, dt)
        item = q.element_size()
        nbytes = item * (q.numel() + k.numel() + v.numel() + q.numel())
        nops = 2 * (d + d) * b * h * s * (s + 1) // 2  # valid causal pairs
        cases.append(dict(
            kernel="flash_attention", role=role, shape=dict(
                B=b, H=h, Sq=s, Skv=s, dh=d, dv=d, dtype=str(dt), causal=True),
            bound=bound(nbytes, nops, _ops_rate(dt)),
            run=lambda q=q, k=k, v=v: ops.flash_attention(q, k, v),
            plain=lambda q=q, k=k, v=v: fa.flash_attention_plain(q, k, v),
            library=lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                q, k, v, is_causal=True),
            library_name="F.scaled_dot_product_attention(is_causal=True)",
            tol=MAIN_TOL[dt]))
    for role, b, h, s, d, dt, full in sizes["decode"]:
        q, k, v = _decode_inputs(g, dev, b, h, s, d, d, dt)
        length = (torch.full((b,), s, device=dev, dtype=torch.int32) if full
                  else torch.randint(1, s + 1, (b,), generator=g, device=dev,
                                     dtype=torch.int32))
        valid = int(length.sum())
        item = q.element_size()
        mask = (torch.arange(s, device=dev)[None, :] < length[:, None])[
            :, None, None]
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)
        cases.append(dict(
            kernel="flash_decode", role=role, shape=dict(
                B=b, H=h, S=s, dh=d, dv=d, dtype=str(dt), valid_keys=valid,
                chunk=fa.decode_split(s, b * h)[0]),
            bound=bound(item * (valid * h * 2 * d + 2 * b * h * d) + 4 * b,
                        2 * 2 * d * h * valid, _ops_rate(dt)),
            run=lambda q=q, k=k, v=v, n=length: ops.flash_decode(
                q, k, v, length=n),
            plain=lambda q=q, k=k, v=v, n=length: fa.flash_decode_plain(
                q, k, v, length=n),
            library=lambda q=q, kt=kt, vt=vt, mask=mask:
                F.scaled_dot_product_attention(
                    q[:, :, None], kt, vt, attn_mask=mask)[:, :, 0],
            library_name="F.scaled_dot_product_attention, (B, 1, 1, S) bool "
                         "mask",
            tol=MAIN_TOL[dt]))
    v_rows, d = sizes["bag_table"]
    table = torch.randn(v_rows, d, generator=g, device=dev)
    for role, b, l in sizes["bag"]:
        idx = _bag_ids(g, dev, v_rows, b, l)
        rows = int((idx >= 0).sum())
        # the yardstick's inputs are built outside the timed call: pads read
        # row 0 with weight 0; the mean weights each row by 1 / max(count, 1)
        valid = (idx >= 0).float()
        lib_idx = idx.clamp(min=0)
        weights = dict(sum=valid, mean=valid / valid.sum(-1, keepdim=True)
                       .clamp(min=1))
        for mode in ("sum", "mean"):
            cases.append(dict(
                kernel="embedding_bag", role=role, shape=dict(
                    V=v_rows, D=d, B=b, L=l, mode=mode, valid_rows=rows,
                    plan=eb.table_plan(table, idx)._asdict()),
                bound=bound(4 * (rows * d + b * l + b * d), rows * d,
                            F32_OPS_PER_S),
                run=lambda idx=idx, mode=mode: ops.embedding_bag(
                    table, idx, mode=mode),
                plain=lambda idx=idx, mode=mode: eb.embedding_bag_plain(
                    table, idx, mode=mode),
                library=lambda li=lib_idx, w=weights[mode]: F.embedding_bag(
                    li, table, mode="sum", per_sample_weights=w),
                library_name="F.embedding_bag(mode='sum', per_sample_weights="
                             + ("(idx >= 0))" if mode == "sum" else
                                "(idx >= 0) / max(count, 1))"),
                tol=(BAG_TOL[F32], BAG_TOL[F32]), device_ms=True))

    fa.reset_launches()
    eb.reset_launches()  # the path starts here
    outs, routes = [], []
    for c in cases:
        before = dict(fa.launches)
        outs.append(c["run"]())
        routes.append([n for n in fa.launches if fa.launches[n] > before[n]])
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = dict(**fa.launches, **eb.launches)  # read just after the path
    if not rehearse:
        for name, n in launches.items():
            if not name.startswith("flash_attention_bwd"):  # phase 11's
                require(n > 0, f"{name} was never launched on phase 6's "
                        "path")
        # the full-width 16-bit rows on the tensor cores, the f32 rows on the
        # SIMT route
        for c, r in zip(cases, routes):
            if c["kernel"] == "flash_attention":
                want_route = ("flash_attention_simt" if c["shape"]["dtype"]
                              == str(F32) else "flash_attention_wgmma")
                require(r == [want_route], f"{c['role']} launched {r}, "
                        f"not {want_route}")

    rows = []
    for c, out, r in zip(cases, outs, routes):
        what = f"{c['kernel']} {c['role']}"
        row = dict(kernel=c["kernel"], role=c["role"], **c["shape"])
        if c["kernel"] == "flash_attention":
            row["route"] = r
        row["bound_ms"], row["bound_by"] = c["bound"]
        want = c["plain"]()
        atol, rtol = row["tol"] = c["tol"]
        row["ref_rms"] = float(want.float().square().mean().sqrt())
        row["max_abs_err"] = _agree(out, want, atol, what, rtol=rtol)
        # how far the yardstick's own rounding is from the plain version
        row["library"] = c["library_name"]
        row["library_max_abs_diff"] = float(
            (c["library"]().float() - want.float()).abs().max())
        del out, want
        if not rehearse:
            row["ms"] = time_ms(c["run"])
            if c.get("device_ms"):
                row["device_ms"] = time_graph_ms(c["run"])
            row["plain_ms"] = time_ms(c["plain"], reps=5, inner=2)
            row["library_ms"] = time_ms(c["library"])
        rows.append(row)
        log("  " + json.dumps(row))
    return rows, launches


# --------------------------------------------------------------------------
# phase 7: the cover-tree slice
# --------------------------------------------------------------------------
CT_T = 3.0  # the JAX cover-tree benchmark's T (benchmarks/bench_covertree.py)
CT_EPS = 0.5  # the descent's default
CT_SHARDS = 4  # phase 5's shard count, on the one card


def _oracle_margin(tree, dist_of, eps):
    """Walk the NumPy oracle's descent (``covertree.search``, no quota) for
    one query and return the least relative distance between a value it
    tests and that test's threshold (the level filter and the ε stop): f32
    rounding can flip a test only that close to its threshold."""
    import numpy as np

    memo = {}

    def dq_of(ids):
        new = [int(i) for i in ids if int(i) not in memo]
        if new:
            for i, v in zip(new, dist_of(np.asarray(new)) * tree.scale):
                memo[i] = float(v)
        return np.asarray([memo[int(i)] for i in ids])

    q_i = tree.levels[0]
    dq_of(q_i)
    margin = math.inf
    for j in range(tree.depth - 1):
        two_i = tree.level_scales[j]
        nxt = set(int(p) for p in q_i)
        for p in q_i:
            nxt.update(tree.children[j].get(int(p), []).tolist())
        q = np.asarray(sorted(nxt))
        dq = dq_of(q)
        thr = dq.min() + two_i
        margin = min(margin, float((np.abs(dq - thr) / thr).min()))
        keep = dq <= thr
        q_i = q[keep]
        stop = two_i * (1.0 + 1.0 / eps)
        margin = min(margin, abs(float(dq[keep].min()) - stop) / stop)
        if dq[keep].min() >= stop:
            break
    return margin


def _same_tree(a, b):
    import numpy as np

    return (a.scale == b.scale and a.level_scales == b.level_scales
            and len(a.levels) == len(b.levels)
            and all(np.array_equal(x, y) for x, y in zip(a.levels, b.levels))
            and all(np.array_equal(x.parents, y.parents)
                    and np.array_equal(x.indptr, y.indptr)
                    and np.array_equal(x.kids, y.kids)
                    for x, y in zip(a.children, b.children)))


def cover_tree_cross(dev, n, dim_d, dim_D, n_queries):
    """At N=n: the tree built on the card equals the one built with
    ``device="cpu"``; the descent on the card equals the CPU descent, and
    its D-call counts the NumPy oracle's, at an unbinding quota. A query
    may differ only at a near-tie (phase 3's rule): two candidates at the
    first differing rank within CROSS_RTOL of each other, or a test of the
    oracle's descent within CROSS_RTOL of its threshold."""
    import numpy as np

    from repro_torch.core import covertree
    from repro_torch.data.synthetic import make_dataset, proxy_quality_sweep

    cpu = torch.device("cpu")
    noise = {k: v for k, v in proxy_quality_sweep("bge-micro-like").items()
             if k != "dim_d"}
    data = make_dataset(n=n, n_queries=n_queries, dim_D=dim_D, dim_d=dim_d,
                        n_clusters=max(1, n // POINTS_PER_CLUSTER), seed=3,
                        device=dev, **noise)
    out = {}
    t0 = time.perf_counter()
    tree = covertree.build(data.corpus_d, T=CT_T, device=dev)
    out["build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tree_cpu = covertree.build(data.corpus_d.cpu(), T=CT_T, device=cpu)
    out["build_cpu_s"] = time.perf_counter() - t0
    require(_same_tree(tree, tree_cpu), "cover tree: the card's build differs "
            "from the CPU's")
    flat = covertree.flatten(tree, device=dev)
    flat_cpu = covertree.flatten(tree_cpu, device=cpu)
    require(torch.equal(flat.children.cpu(), flat_cpu.children))
    log(f"  cover tree N={n}: card build {out['build_s']:.3f} s, cpu "
        f"{out['build_cpu_s']:.3f} s, covers "
        f"{[len(c) for c in tree.levels]}, fanout {flat.fanout}: equal")

    a = covertree.search_corpus(flat, data.corpus_D, data.queries_D,
                                eps=CT_EPS, k=10, device=dev)
    c = covertree.search_corpus(flat_cpu, data.corpus_D.cpu(),
                                data.queries_D.cpu(), eps=CT_EPS, k=10,
                                device=cpu)
    x_D = data.corpus_D.cpu().double().numpy()
    q_D = data.queries_D.cpu().double().numpy()
    ids_a, ids_c = a.ids.cpu(), c.ids
    calls_a, calls_c = a.n_calls.cpu(), c.n_calls
    near = []
    for b in range(n_queries):
        def dist_of(ids, b=b):  # D in f64, as the oracle's tests use it
            d = x_D[ids] - q_D[b]
            return np.sqrt((d * d).sum(-1))

        oids, _, ocalls = covertree.search(tree_cpu, dist_of, eps=CT_EPS, k=10)
        for what, ia, ca, ib, cb in (
                ("card vs cpu", ids_a[b], calls_a[b], ids_c[b], calls_c[b]),
                ("card vs oracle", ids_a[b], calls_a[b], None, ocalls),
                ("cpu vs oracle", ids_c[b], calls_c[b], None, ocalls)):
            same_ids = ib is None or torch.equal(ia, ib)
            if ib is None:  # the oracle's ids lead the engine's row
                row = ia[ia >= 0].numpy()
                same_ids = list(row) == list(oids[:len(row)])
            if same_ids and int(ca) == int(cb):
                continue
            margin = _oracle_margin(tree_cpu, dist_of, CT_EPS)
            gap = math.inf
            if not same_ids:
                other = (ib if ib is not None else torch.as_tensor(
                    oids[:len(ia)]))
                m = min(len(ia), len(other))
                diff = (ia[:m] != other[:m]).nonzero()
                if len(diff):
                    i = int(diff[0])
                    da, db = dist_of([int(ia[i]), int(other[i])])
                    gap = abs(da - db) / max(da, db, 1e-30)
            ok = min(gap, margin) <= CROSS_RTOL
            log(f"  query {b} {what}: calls {int(ca)} / {int(cb)}, ids "
                f"{'same' if same_ids else 'differ'}; rank gap {gap:.3e}, "
                f"oracle's least test margin {margin:.3e} "
                f"({'near-tie, allowed' if ok else 'NOT a near-tie'})")
            require(ok, f"cover tree query {b} {what} differs beyond a "
                    "near-tie")
            near.append(dict(query=b, what=what, gap=gap, margin=margin))
    log(f"  cover-tree descent: {n_queries} queries, card = cpu = oracle up "
        f"to {len(near)} near-tie differences; mean D_calls "
        f"{float(calls_a.float().mean()):.1f}")
    out.update(N=n, covers=[len(c) for c in tree.levels], fanout=flat.fanout,
               near_ties=near, mean_D_calls=float(calls_a.float().mean()))
    return out


def _hold_wave(corpus, q, ids, other, pools, rng, what):
    """One search wave held against the plain versions. ``gather_score``
    scores ``ids`` in the path's form (l2, f32 rows) within phase 2's f32
    limit; the merge takes those scores into pools of each size in
    ``pools`` (the best of ``other``, scored plainly, flags drawn from
    ``rng``) and must equal its plain version exactly. Returns the gather's
    max error and the merge shapes (B, P, K)."""
    from repro_torch.kernels import backend, l2_topk, ref

    b = q.shape[0]

    def plain(ids):  # row slices: a whole (B, K, 4096) gather can be 16 GB
        return torch.cat([l2_topk.gather_score_plain(
            corpus, q[i:i + 16], ids[i:i + 16], metric="l2")
            for i in range(0, b, 16)])

    got = l2_topk.gather_score(corpus, q, ids, metric="l2")
    want = plain(ids)
    fin = torch.isfinite(want)
    require(torch.equal(fin, torch.isfinite(got)),
            f"{what}: gather_score masks other lanes than plain")
    err = (got[fin] - want[fin]).abs()
    scale = _term_scale(backend.as_corpus_view(corpus), q, ids, "l2")
    lim = 1e-5 * torch.maximum(want[fin].abs(), scale[fin])
    g_err = float(err.max()) if err.numel() else 0.0
    require(bool((err <= lim).all()),
            f"{what}: gather_score max err {g_err:.3e}")
    od, oi = torch.sort(plain(other), dim=1, stable=True)
    oi = other.gather(1, oi)
    shapes = []
    for p in pools:
        pd = od[:, :p].contiguous()
        pi = torch.where(torch.isfinite(pd), oi[:, :p],
                         torch.full_like(oi[:, :p], -1)).contiguous()
        pf = torch.from_numpy(rng.random((b, p)) < 0.5).to(q.device)
        args = (pi, pd, pf, ids, got)
        res = l2_topk.merge_pool_batch(*args)
        for name, x, y in zip(("ids", "dists", "flags"), res,
                              ref.merge_pool_batch_ref(*args)):
            require(torch.equal(x, y), f"{what}: merge "
                    f"({b},{p},{ids.shape[1]}) {name} differs")
        shapes.append([b, p, int(ids.shape[1])])
    return g_err, shapes


def check_cover_wave(dev, tree, flat, data, quotas):
    """One level wave of the full-size descent against the plain versions,
    on the card's inputs at the path's shapes: the level whose child rows
    are widest, ``wave_chunk(fanout)`` centers a query drawn from that
    level's members (row 0 takes the widest row), so K = chunk x R lanes,
    most of them -1 as in the slab rows. ``gather_score`` scores the wave
    in the path's form (l2, f32 rows) within phase 2's f32 limit; the merge
    takes it into pools of each Q (the best Q of another such wave, flags
    drawn at random) and must equal its plain version exactly. Its launches
    come after the path's counts are read."""
    import numpy as np

    from repro_torch.core import covertree

    b = data.queries_D.shape[0]
    chunk = covertree.wave_chunk(flat.fanout)
    t = int(np.argmax([np.diff(ch.indptr).max() for ch in tree.children]))
    members = np.asarray(tree.levels[t])
    rng = np.random.default_rng(17)

    def wave(first=None):
        # distinct centers a row; slots past the level's members stay -1
        c = np.full((b, chunk), -1)
        m = min(chunk, len(members))
        for i in range(b):
            c[i, :m] = rng.choice(members, m, replace=False)
        if first is not None and first not in c[0]:
            c[0, 0] = first
        c = torch.from_numpy(c).to(dev)
        ids = flat.children[t][c.clamp(min=0)]
        ids = torch.where((c >= 0)[:, :, None], ids, torch.full_like(ids, -1))
        return ids.reshape(b, -1).contiguous()

    ch = tree.children[t]
    ids = wave(first=int(ch.parents[np.argmax(np.diff(ch.indptr))]))
    other = wave()
    g_err, shapes = _hold_wave(data.corpus_D, data.queries_D, ids, other,
                               quotas, rng, "cover-tree wave")
    out = dict(level=t, chunk=chunk, B=b, K=int(ids.shape[1]),
               live_lanes=float((ids >= 0).float().mean()),
               gather_max_abs_err=g_err, merge_shapes=shapes)
    log(f"  level wave check: level {t}, {chunk} centers a query, K "
        f"{out['K']} ({out['live_lanes']:.4f} of lanes live): gather_score "
        f"max err {g_err:.3e}, merge exact at {out['merge_shapes']}")
    return out


def cover_tree_slice(dev, ph4, diskann_runs, quotas, rehearse):
    """Phase 4's data through the cover-tree instantiation: the tree built
    on the card from d at T=3, flattened, then Algorithm 3 under D at each
    Q through ``search_corpus`` (timed) and ``bimetric_search`` (the same
    result, d_calls 0), beside phase 4's bi-metric DiskANN runs; then both
    again at S=4 shards on the one card (the descent stepped by a
    ``beam.ShardedStepper``), bit-equal to shards=1, and at the smallest Q
    with the column-sharded bitmap as well (``auto`` picks the replicated
    sorted set at these quotas)."""
    from repro_torch.core import bimetric, covertree, metrics
    from repro_torch.distributed import sharding
    from repro_torch.kernels import l2_topk

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    data, k, true_ids = ph4["data"], ph4["k"], ph4["true_ids"]
    n = data.corpus_d.shape[0]
    n_queries = data.queries_d.shape[0]
    one = torch.device("cuda", 0) if dev.type == "cuda" else dev
    mesh = sharding.search_mesh(CT_SHARDS, devices=[one] * CT_SHARDS)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    out = dict(N=n, T=CT_T, eps=CT_EPS)
    l2_topk.reset_launches()  # the cover-tree path starts here
    t0 = time.perf_counter()
    tree = covertree.build(data.corpus_d, T=CT_T, device=dev)
    out["build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    flat = covertree.flatten(tree, device=dev)
    sync()
    out["flatten_s"] = time.perf_counter() - t0
    out.update(depth=flat.depth, fanout=flat.fanout,
               covers=[len(c) for c in tree.levels],
               # each child row holds its parent: its width is the group's
               level_fanout=[int(max(ch.indptr[1:] - ch.indptr[:-1]))
                             for ch in tree.children],
               table_bytes=flat.children.numel() * 4)
    log(f"  build N={n}: {out['build_s']:.3f} s, flatten "
        f"{out['flatten_s']:.3f} s; depth {flat.depth}, fanout {flat.fanout} "
        f"(widest row per level {out['level_fanout']}), covers "
        f"{out['covers']}, table {out['table_bytes']} bytes")
    runs = []
    for q in quotas:
        before = dict(l2_topk.launches)
        t0 = time.perf_counter()
        res = covertree.search_corpus(flat, data.corpus_D, data.queries_D,
                                      eps=CT_EPS, k=k, quota=q, device=dev)
        sync()
        dt = time.perf_counter() - t0
        delta = {kk: l2_topk.launches[kk] - before[kk] for kk in before}
        require(res.ids.shape == (n_queries, k))
        require(int(res.n_calls.max()) <= q, ("cover tree", q))
        scored = res.ids >= 0
        require(bool(torch.isfinite(res.dists[scored]).all())
                and bool(torch.isinf(res.dists[~scored]).all()),
                "cover tree: non-finite distance on a scored rank")
        bm = bimetric.bimetric_search(
            None, None, flat, data.queries_d, data.queries_D, n_points=n,
            quota=q, k=k, corpora=(data.corpus_d, data.corpus_D), eps=CT_EPS,
            device=dev)
        require(bool((bm.d_calls == 0).all()), "cover tree: d_calls != 0")
        require(torch.equal(bm.ids, res.ids)
                and torch.equal(bm.D_calls, res.n_calls),
                "cover tree: bimetric_search differs from search_corpus")
        sharded = []
        for dedup in ("auto", "bitmap") if q == min(quotas) else ("auto",):
            before_s = dict(l2_topk.launches)
            t0 = time.perf_counter()
            res_s = covertree.search_corpus(
                flat, data.corpus_D, data.queries_D, eps=CT_EPS, k=k,
                quota=q, shards=CT_SHARDS, mesh=mesh, dedup=dedup,
                device=dev)
            sync()
            dt_s = time.perf_counter() - t0
            delta_s = {kk: l2_topk.launches[kk] - before_s[kk]
                       for kk in before_s}
            for f in res._fields:
                require(torch.equal(getattr(res_s, f), getattr(res, f)),
                        f"cover tree S={CT_SHARDS} ({dedup}): {f} differs "
                        "from shards=1")
            require(delta_s["gather_score_local"] == 0
                    and delta_s == {kk: delta[kk] for kk in delta},
                    f"cover tree S={CT_SHARDS}: launches {delta_s}")
            sharded.append(dict(S=CT_SHARDS, dedup=dedup, query_s=dt_s,
                                qps=n_queries / dt_s, launches=delta_s))
            log(f"  cover tree Q={q:5d} S={CT_SHARDS} ({dedup}): {dt_s:.3f} "
                f"s ({dt_s / dt:.3f}x shards=1), launches {delta_s}, "
                "bit-equal to shards=1")
        bm_s = bimetric.bimetric_search(
            None, None, flat, data.queries_d, data.queries_D, n_points=n,
            quota=q, k=k, corpora=(data.corpus_d, data.corpus_D), eps=CT_EPS,
            shards=CT_SHARDS, mesh=mesh, device=dev)
        for f in bm._fields:
            require(torch.equal(getattr(bm_s, f), getattr(bm, f)),
                    f"cover tree bimetric_search S={CT_SHARDS}: {f} differs "
                    "from shards=1")
        waves = delta["beam_merge_topk"]
        run = dict(Q=q, query_s=dt, qps=n_queries / dt,
                   recall_at_10=float(metrics.recall_at_k(
                       res.ids, true_ids).mean()),
                   ndcg_at_10=float(metrics.ndcg_at_k(res.ids,
                                                      true_ids).mean()),
                   mean_D_calls=float(res.n_calls.float().mean()),
                   max_D_calls=int(res.n_calls.max()), launches=delta,
                   s_per_wave=dt / max(waves, 1), sharded=sharded)
        dk = next(r for r in diskann_runs
                  if r["method"] == "bimetric" and r["Q"] == q)
        run["diskann"] = {kk: dk[kk] for kk in (
            "query_s", "qps", "recall_at_10", "ndcg_at_10", "mean_D_calls",
            "max_D_calls")}
        log(f"  cover tree Q={q:5d}: {dt:.3f} s, {run['qps']:.1f} q/s, "
            f"recall@10 {run['recall_at_10']:.4f}, nDCG@10 "
            f"{run['ndcg_at_10']:.4f}, D_calls mean "
            f"{run['mean_D_calls']:.1f} max {run['max_D_calls']}, launches "
            f"{delta}, {run['s_per_wave']:.5f} s a wave")
        log(f"    bi-metric DiskANN (phase 4) Q={q:5d}: {dk['query_s']:.3f} "
            f"s, recall@10 {dk['recall_at_10']:.4f}, nDCG@10 "
            f"{dk['ndcg_at_10']:.4f}, D_calls mean {dk['mean_D_calls']:.1f}")
        runs.append(run)
    launches = dict(l2_topk.launches)  # read just after the path
    out.update(runs=runs, launches=launches)
    if dev.type == "cuda":
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        log(f"  max_memory_allocated {out['max_memory_allocated']} bytes")
    require(launches["gather_score_local"] == 0)
    if not rehearse:
        for name in ("gather_score", "beam_merge_topk"):
            require(launches[name] > 0,
                    f"{name} was never launched on the cover-tree path")
    out["wave_check"] = check_cover_wave(dev, tree, flat, data, quotas)
    return out


# --------------------------------------------------------------------------
# phase 8: the towers
# --------------------------------------------------------------------------
# limits of a tower on the card against its copy on the CPU, on the unit
# embeddings: f32 (the cheap tower) and bf16 (JAX's bf16 tolerance and a
# cosine per row); fixed before the first run
TOWER_F32_ABS = 1e-4
TOWER_BF16_ABS, TOWER_BF16_COS = 2e-2, 0.999
TOWER_SEEDS = dict(cheap=1, expensive=2)  # init_params seeds


def tower_flops(cfg, n_docs, s):
    """Operations of ``embed_pool`` over n_docs rows of s tokens: the
    layers' products (2 a weight a token), the causal attention
    (2·(dh + dv) a valid query-key pair a head) and the embedding head."""
    d, h, hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    weights = d * h * hd + 2 * d * hk * hd + h * hd * d + 3 * d * cfg.d_ff
    attn = 2 * (hd + hd) * h * s * (s + 1) // 2
    per_doc = cfg.n_layers * (2 * weights * s + attn) + 2 * d * cfg.embed_dim
    return n_docs * per_doc


def tower_attention(dev, shapes, rehearse):
    """(a) each tower's attention at the exact shapes of its path (a batch
    of docs and one of queries), through ``layers.blockwise_attention``
    (GQA repeated to H heads) against the plain version on the repeated
    heads; the route's counter must tick once. Then, timed: the kernel
    alone beside the function's bound, its plain version and SDPA on the
    same (B, H, S, d) operands, and the layout work around it (q, k, v to
    (B, H, S, d), k and v repeated, the output back to (B, S, H·dv))."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import layers

    g = torch.Generator(device=dev).manual_seed(18)
    rows = []
    for role, b, h, hkv, s, dh, dt in shapes:
        q = torch.randn(b, s, h, dh, generator=g, device=dev).to(dt)
        k, v = (torch.randn(b, s, hkv, dh, generator=g, device=dev).to(dt)
                for _ in range(2))
        route = f"flash_attention_{fa._attention_route(dt, dh, dh)}"
        before = dict(fa.launches)
        got = layers.blockwise_attention(q, k, v, causal=True)
        ticked = [n for n in fa.launches if fa.launches[n] > before[n]]
        require(rehearse or ticked == [route],
                f"tower attention {role}: launched {ticked}, not {route}")
        rep = h // hkv
        heads = [t.transpose(1, 2).contiguous() for t in (
            q, layers.repeat_kv(k, rep), layers.repeat_kv(v, rep))]
        want = fa.flash_attention_plain(*heads).transpose(1, 2)
        atol, rtol = MAIN_TOL[dt]
        what = f"tower attention {role} {(b, h, hkv, s, dh, dt)}"
        row = dict(role=role, B=b, H=h, Hkv=hkv, S=s, dh=dh, dtype=str(dt),
                   route=route, tol=(atol, rtol),
                   max_abs_err=_agree(got, want, atol, what, rtol=rtol))
        # the function's bytes: q and the output at H heads, k and v at Hkv,
        # once each; the valid causal pairs
        row["bound_ms"], row["bound_by"] = bound(
            (2 * q.numel() + k.numel() + v.numel()) * q.element_size(),
            2 * (dh + dh) * b * h * s * (s + 1) // 2, _ops_rate(dt))
        del got, want
        if not rehearse:
            def layout(q=q, k=k, v=v, rep=rep, out=heads[0], b=b, s=s, h=h,
                       dh=dh):  # blockwise_attention's copies around the call
                for t, r in ((q, 1), (k, rep), (v, rep)):
                    layers.heads_first(t, r)
                out.transpose(1, 2).reshape(b, s, h * dh)

            row["kernel_ms"] = time_ms(lambda hd=heads: fa.flash_attention(
                *hd))
            row["plain_ms"] = time_ms(lambda hd=heads: fa.flash_attention_plain(
                *hd), reps=5, inner=2)
            row["library_ms"] = time_ms(
                lambda hd=heads: F.scaled_dot_product_attention(
                    *hd, is_causal=True))
            row["layout_ms"] = time_ms(layout)
        rows.append(row)
        log("  " + json.dumps(row))
    return rows


def _cut_copy(model, n_layers, device):
    """A copy on ``device`` of ``model``'s first ``n_layers`` layers, its
    token table, final norm and head."""
    import dataclasses

    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(model.cfg, n_layers=n_layers)
    keep = {k: v for k, v in model.state_dict().items()
            if not k.startswith("blocks.") or int(k.split(".")[1]) < n_layers}
    out = T.Transformer(cfg, device=device)
    out.load_state_dict(keep)
    return out


def tower_cross(dev, cheap, expensive, doc_len, cut_layers):
    """(b) each tower on the card against its copy on the CPU: the cheap
    tower whole on 8 docs, the expensive one cut to its first layers on 2
    docs."""
    from repro_torch.serve.engine import EmbedTower

    rng = np.random.default_rng(8)
    out = {}
    for name, model, n_docs, layers_ in (
            ("cheap", cheap, 8, cheap.cfg.n_layers),
            ("expensive", expensive, 2, cut_layers)):
        card = (model if layers_ == model.cfg.n_layers
                else _cut_copy(model, layers_, dev))
        host = _cut_copy(model, layers_, "cpu")
        toks = rng.integers(0, model.cfg.vocab, (n_docs, doc_len),
                            dtype=np.int32)
        t0 = time.perf_counter()
        # one batch of exactly n_docs rows: a default batch would pad them
        want = EmbedTower(host, device="cpu").embed(toks, batch=n_docs)
        cpu_s = time.perf_counter() - t0

        def compare(got, want=want, name=name):
            require(got.shape == want.shape and np.isfinite(got).all(),
                    f"tower {name}: shape {got.shape} or non-finite values")
            return dict(max_abs=float(np.abs(got - want).max()),
                        min_cos=float(np.min(np.sum(got * want, axis=1))))

        res = dict(n_layers=layers_, docs=n_docs, tokens=doc_len,
                   dtype=str(model.cfg.dtype), cpu_s=cpu_s,
                   **compare(EmbedTower(card, device=dev).embed(
                       toks, batch=n_docs)))
        if model.cfg.dtype == torch.bfloat16:
            require(res["max_abs"] <= TOWER_BF16_ABS
                    and res["min_cos"] >= TOWER_BF16_COS,
                    f"tower {name} card vs CPU: {res}")
        else:
            require(res["max_abs"] <= TOWER_F32_ABS,
                    f"tower {name} card vs CPU: {res}")
        del card, host
        out[name] = res
        log(f"  tower {name} ({layers_} layers) card vs CPU: {res}")
    return out


def check_tower_waves(idx, emb, pools):
    """The search kernels at the shapes of phase 8's path, after its counts
    are read: for each tower's embeddings, an expansion wave (each query
    scores the graph row of one vertex, K = R) and, under D, the re-rank's
    scoring wave (K = its largest pool, distinct ids), each held by
    ``_hold_wave`` with merges into pools of the path's sizes."""
    rng = np.random.default_rng(19)
    adj = idx.adjacency
    out = []
    for name in ("cheap", "expensive"):
        corpus, q = emb[name, "docs"], emb[name, "queries"]
        b, n = q.shape[0], corpus.shape[0]
        rows = torch.from_numpy(rng.integers(0, n, b)).to(adj.device)
        distinct = lambda w: torch.from_numpy(np.stack([
            rng.choice(n, w, replace=False) for _ in range(b)])).to(
                adj.device, torch.int32)
        waves = [("expansion", adj[rows].contiguous())]
        if name == "expensive":
            waves.append(("re-rank", distinct(max(pools))))
        for kind, ids in waves:
            g_err, shapes = _hold_wave(corpus, q, ids, distinct(max(pools)),
                                       pools, rng, f"{name} {kind} wave")
            out.append(dict(tower=name, wave=kind, dim=corpus.shape[1],
                            gather_max_abs_err=g_err, merge_shapes=shapes))
            log(f"  {name} {kind} wave (dim {corpus.shape[1]}, K "
                f"{ids.shape[1]}): gather_score max err {g_err:.3e}, merge "
                f"exact at {shapes}")
    return out


def profile_batch(fn):
    """Device time of one ``fn()`` by kernel kind, from a ``torch.profiler``
    trace: products (cuBLAS's kernels: ``nvjet``, ``gemm``, ``xmma``), the
    attention kernel, and the rest (elementwise, reductions, copies), in
    ms, with the wall time around it, the device's idle share of that wall
    time and the six kernels that took longest. ``None`` where the trace
    shows no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kinds = dict(products=0.0, attention=0.0, other=0.0)
    top = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0.0)
        if not us or ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = ev.key.lower()
        kind = ("attention" if "flash_attention" in name else "products"
                if any(w in name for w in ("nvjet", "gemm", "xmma", "cutlass",
                                           "cublas")) else "other")
        kinds[kind] += us / 1e3
        top.append((us / 1e3, ev.count, ev.key[:90]))
    busy = sum(kinds.values())
    if busy == 0:
        return None
    return dict(wall_ms=wall * 1e3, busy_ms=busy,
                idle_share=1 - busy / (wall * 1e3),
                **{f"{k}_ms": v for k, v in kinds.items()},
                top=sorted(top, reverse=True)[:6])


def tower_slice(dev, sizes, rehearse):
    """Phase 8: both towers drawn on the card at full size, (a) their
    attention at its shapes, (b) each against its CPU copy, then (c) the
    path of ``launch/serve.py``: docs and queries embedded through
    ``EmbedTower`` at batch 64, the graph built on the d embeddings, and
    ``bimetric_search`` / ``rerank_search`` under D, recall@10 against the
    brute-force top-10 under D."""
    from repro_torch.configs.bimetric_paper import (PAPER_DISKANN,
                                                    BiMetricSystemConfig)
    from repro_torch.core import bimetric, distances, metrics, vamana
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import l2_topk
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import EmbedTower

    tw = sizes["towers"]
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    out = {}
    models = {}
    for name in ("cheap", "expensive"):
        cfg = tw[name]()
        t0 = time.perf_counter()
        models[name] = T.init_params(TOWER_SEEDS[name], cfg, device=dev)
        sync()
        n_params = sum(p.numel() for p in models[name].parameters())
        out[f"{name}_init"] = dict(config=cfg.name, n_layers=cfg.n_layers,
                                   d_model=cfg.d_model, dtype=str(cfg.dtype),
                                   params=n_params,
                                   s=time.perf_counter() - t0)
        log(f"  {name} tower {cfg.name}: {n_params} parameters drawn on "
            f"{dev} in {out[f'{name}_init']['s']:.3f} s")
    cheap, expensive = models["cheap"], models["expensive"]
    batch, doc_len, q_len = tw["batch"], tw["doc_len"], tw["query_len"]

    with torch.inference_mode():  # serving's mode: no autograd graph
        out["attention"] = tower_attention(dev, [
            (name, batch, m.cfg.n_heads, m.cfg.n_kv_heads, s, m.cfg.head_dim,
             m.cfg.dtype) for name, m in models.items()
            for s in (doc_len, q_len)], rehearse)
    out["cross"] = tower_cross(dev, cheap, expensive, doc_len,
                               tw["cut_layers"])

    # (c) the path of launch/serve.py; tokens from numpy seed 0
    rng = np.random.default_rng(0)
    n, n_q, vocab = tw["docs"], tw["queries"], expensive.cfg.vocab
    docs = rng.integers(0, vocab, (n, doc_len), dtype=np.int32)
    queries = docs[rng.integers(0, n, n_q), :q_len].copy()
    queries[:, : q_len // 2] = rng.integers(0, vocab, (n_q, q_len // 2))
    towers = dict(cheap=EmbedTower(cheap, device=dev),
                  expensive=EmbedTower(expensive, device=dev))
    k = BiMetricSystemConfig().k
    fa.reset_launches()
    l2_topk.reset_launches()  # the path starts here
    emb, embed_s = {}, {}
    for name, tower in towers.items():
        for what, toks in (("docs", docs), ("queries", queries)):
            t0 = time.perf_counter()
            emb[name, what] = torch.from_numpy(
                tower.embed(toks, batch=batch)).to(dev)
            embed_s[name, what] = time.perf_counter() - t0
    em_D = distances.EmbeddingMetric(emb["expensive", "docs"])
    em_d = distances.EmbeddingMetric(emb["cheap", "docs"])
    cfg = PAPER_DISKANN._replace(build_batch=min(PAPER_DISKANN.build_batch, n))
    t0 = time.perf_counter()
    idx = vamana.build(emb["cheap", "docs"], cfg, device=dev)
    sync()
    out["build_s"] = time.perf_counter() - t0
    true_ids, _ = em_D.brute_force(emb["expensive", "queries"], k)
    runs = []
    for q in tw["quotas"]:
        for method in ("bimetric", "rerank"):
            fn = (bimetric.bimetric_search if method == "bimetric"
                  else bimetric.rerank_search)
            t0 = time.perf_counter()
            res = fn(em_d.dists_batch, em_D.dists_batch, idx,
                     emb["cheap", "queries"], emb["expensive", "queries"],
                     n_points=n, quota=q, k=k, device=dev)
            sync()
            dt = time.perf_counter() - t0
            require(res.ids.shape == (n_q, k))
            require(torch.isfinite(res.dists).all())
            require(int(res.D_calls.max()) <= q, (method, q))
            runs.append(dict(
                method=method, Q=q, query_s=dt,
                recall_at_10=float(metrics.recall_at_k(res.ids,
                                                       true_ids).mean()),
                mean_D_calls=float(res.D_calls.float().mean()),
                max_D_calls=int(res.D_calls.max())))
            log(f"  {method:8s} Q={q:4d}: {dt:.3f} s, recall@10 "
                f"{runs[-1]['recall_at_10']:.4f}, D_calls mean "
                f"{runs[-1]['mean_D_calls']:.1f} max "
                f"{runs[-1]['max_D_calls']}")
    launches = dict(**fa.launches, **l2_topk.launches)  # just after the path
    out.update(runs=runs, launches=launches)

    for key, e in emb.items():
        require(bool(torch.isfinite(e).all()), f"{key}: non-finite")
        norm_err = float((e.norm(dim=1) - 1).abs().max())
        require(norm_err <= 1e-5, f"{key}: not unit rows ({norm_err:.2e})")
    n_batches = {what: -(-len(t) // batch)
                 for what, t in (("docs", docs), ("queries", queries))}
    per_tower = n_batches["docs"] + n_batches["queries"]
    if not rehearse:
        require(launches["flash_attention_wgmma"]
                == expensive.cfg.n_layers * per_tower,
                f"wgmma launches {launches['flash_attention_wgmma']}")
        require(launches["flash_attention_simt"]
                == cheap.cfg.n_layers * per_tower,
                f"simt launches {launches['flash_attention_simt']}")
        for name in ("gather_score", "beam_merge_topk"):
            require(launches[name] > 0, f"{name} was never launched on "
                                        "phase 8's path")
    out["wave_checks"] = check_tower_waves(
        idx, emb, sorted({*tw["quotas"], cfg.l_build}))
    for name, tower in towers.items():  # one batch embedded twice
        require(np.array_equal(tower.embed(docs[:batch], batch=batch),
                               tower.embed(docs[:batch], batch=batch)),
                f"{name}: two embed calls of one batch differ")

    for name, model in models.items():
        s = embed_s[name, "docs"]
        ops = tower_flops(model.cfg, n, doc_len)
        out[name] = dict(
            docs_s=s, queries_s=embed_s[name, "queries"],
            tokens_per_s=n * doc_len / s, doc_tflop=ops / 1e12,
            tflop_per_s=ops / s / 1e12, batches=n_batches,
            step_s=s / n_batches["docs"])
        if model.cfg.dtype == torch.bfloat16:
            out[name]["bound_s"] = ops / BF16_OPS_PER_S
        att = next(r for r in out["attention"]
                   if r["role"] == name and r["S"] == doc_len)
        if "layout_ms" in att:  # per layer at the doc batch, over a step
            for part in ("layout", "kernel"):
                out[name][f"attention_{part}_share"] = (
                    model.cfg.n_layers * att[f"{part}_ms"] / 1e3
                    / out[name]["step_s"])
        if not rehearse:  # one doc batch, traced: where a step's time goes
            out[name]["profile"] = profile_batch(
                lambda t=towers[name]: t.embed(docs[:batch], batch=batch))
        log(f"  {name} tower: {json.dumps(out[name])}")
    if dev.type == "cuda":
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        log(f"  max_memory_allocated {out['max_memory_allocated']} bytes")
    # phase 9 serves on these towers, tokens and embeddings
    ph8 = dict(towers=towers, docs=docs, queries=queries, emb=emb, k=k,
               batch=batch)
    return out, ph8


# --------------------------------------------------------------------------
# phase 9: the serving engine
# --------------------------------------------------------------------------
class _TimedTower:
    """An ``EmbedTower`` whose ``embed`` calls are timed: the wall time of
    the tower's forward passes (each call ends in a copy to the host, so
    it waits for the card), and the document batches and rows it embedded
    (calls whose rows are all rows of ``docs``; the engine's query embeds
    are not). The engine calls only ``embed``."""

    def __init__(self, inner, docs):
        self.inner, self.device = inner, inner.device
        self.docs = {row.tobytes() for row in docs}
        self.reset()

    def reset(self):
        self.seconds, self.doc_batches, self.doc_rows = 0.0, 0, 0

    def embed(self, tokens, batch=64):
        t0 = time.perf_counter()
        out = self.inner.embed(tokens, batch=batch)
        self.seconds += time.perf_counter() - t0
        if all(row.tobytes() in self.docs for row in tokens):
            self.doc_batches += -(-len(tokens) // batch)
            self.doc_rows += len(tokens)
        return out


def batch_free(towers, docs, queries, emb, batch, n_few):
    """(a) A tower's embedding of a row must not depend on its batch-mates:
    docs 0..batch-1, embedded in phase 8 as one batch in order, again
    shuffled among docs batch..2·batch-1 over two batches; and the first
    ``n_few`` queries alone in a batch padded with zero rows against the
    full batch of queries. Bit for bit, for both towers. Returns each
    tower's embeddings of ``queries`` (on the card)."""
    rng = np.random.default_rng(20)
    out, q_emb = {}, {}
    for name in ("expensive", "cheap"):
        tw = towers[name]
        perm = rng.permutation(2 * batch)
        got = tw.embed(docs[perm], batch=batch)
        want = emb[name, "docs"][:batch].cpu().numpy()
        mine = perm < batch
        require(np.array_equal(got[mine], want[perm[mine]]),
                f"{name}: a doc's embedding depends on its batch")
        full = tw.embed(queries, batch=batch)
        require(np.array_equal(tw.embed(queries[:n_few], batch=batch),
                               full[:n_few]),
                f"{name}: a query's embedding depends on its batch")
        q_emb[name] = torch.from_numpy(full).to(emb[name, "docs"].device)
        out[name] = dict(docs=batch, queries=n_few, bit_equal=True)
    log(f"  (a) rows bit-equal across batch compositions: {out}")
    return out, q_emb


def _same_results(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        require(np.array_equal(g.ids, w.ids)
                and np.array_equal(g.dists, w.dists)
                and g.stats.D_calls == w.stats.D_calls
                and g.stats.d_calls == w.stats.d_calls,
                f"{what}: request {i} differs from the sync drive")


def _pct(xs):
    return dict(p50=float(np.percentile(xs, 50)),
                p99=float(np.percentile(xs, 99)))


def _share_doc_cache(src, dst):
    """Hand ``src`` engine's D document cache to ``dst`` (the cover-tree
    engine of (e) starts warm; only (b) and (c) start from an empty
    cache). Private state: the engine has no public way to seed it."""
    dst._emb_D = src._emb_D.clone()
    dst._emb_D_valid[:] = src._emb_D_valid


def serve_waves(eng, ct, q_emb, quotas, k):
    """(g) The waves the slot pool sends to the kernels, with B = slots
    queries (``q_emb`` holds each tower's embeddings of them), each held by
    ``_hold_wave`` with merges at the pool size the slot pool gives it.
    Stage 1 under d: an expansion wave (K = R, a vertex's graph row) on the
    cheap embeddings, merged at the stage-1 pool. Stage 2 under D, on the D
    cache (private state, read only), at the slot pool's P: the entry wave
    (each row's Q/2 distinct seeds, -1 padded to the seed cap), a Vamana
    expansion wave and a cover-tree chunk wave of ``ct`` (``wave_chunk``
    distinct centers of the level with the widest child rows, K = chunk x
    R, -1 where a center has fewer children)."""
    rng = np.random.default_rng(21)
    q_d, q_D = q_emb["cheap"], q_emb["expensive"]
    dev, b, n = q_D.device, q_D.shape[0], eng.n
    pow2 = lambda x: 1 << (int(x) - 1).bit_length()
    quota = np.array([quotas[i % 2] for i in range(b)])
    nseed = np.maximum(1, quota // 2)
    p_1 = pow2(np.maximum(32, nseed).max())
    p_vam = pow2(max(max(k, min(x, 2 * max(1, x // 2) + 8)) for x in quotas))
    children, chunk = ct._flat.children, ct._ct_chunk
    p_ct = max(pow2(max(k, len(ct._flat.root_ids), min(n, max(quotas)))),
               chunk)

    def distinct(w):
        return np.stack([rng.choice(n, w, replace=False) for _ in range(b)])

    cap = pow2(nseed.max())
    entry = np.where(np.arange(cap)[None, :] < nseed[:, None],
                     distinct(cap), -1)
    adj = eng.index.adjacency

    def expansion():
        return adj[torch.from_numpy(rng.integers(0, n, b)).to(dev)]

    width = (children >= 0).sum(dim=2).amax(dim=1)
    t = int(torch.argmax(width))
    members = torch.nonzero(children[t, :, 0] >= 0)[:, 0].cpu().numpy()
    m = min(chunk, len(members))
    centers = np.full((b, chunk), -1)
    for i in range(b):
        centers[i, :m] = rng.choice(members, m, replace=False)
    centers = torch.from_numpy(centers).to(dev)
    cover = children[t][centers.clamp(min=0)]
    cover = torch.where((centers >= 0)[:, :, None], cover,
                        torch.full_like(cover, -1)).reshape(b, -1)
    out = []
    for name, corpus, q, ids, p in (
            ("stage-1 expansion", eng.emb_d, q_d, expansion(), p_1),
            ("entry", eng._emb_D, q_D,
             torch.from_numpy(entry).to(dev, torch.int32), p_vam),
            ("vamana expansion", eng._emb_D, q_D, expansion(), p_vam),
            ("cover-tree chunk", eng._emb_D, q_D, cover, p_ct)):
        ids = ids.contiguous()
        other = torch.from_numpy(distinct(p)).to(dev, torch.int32)
        g_err, shapes = _hold_wave(corpus, q, ids, other, [p], rng,
                                   f"serve {name} wave")
        out.append(dict(wave=name, B=b, K=int(ids.shape[1]),
                        dim=int(corpus.shape[1]), P=p,
                        live_lanes=float((ids >= 0).float().mean()),
                        gather_max_abs_err=g_err, merge_shapes=shapes))
        log(f"  (g) {name} wave (B {b}, K {ids.shape[1]}, dim "
            f"{corpus.shape[1]}): gather_score max err {g_err:.3e}, "
            f"merge exact at {shapes}")
    return out


def _sharded_engine(src, shards, **kw):
    """A ``BiMetricEngine`` like ``src`` at ``shards`` on S copies of its
    device (``search_mesh(S, devices=[dev] * S)``), warm from ``src``'s D
    cache. A vamana engine takes ``src``'s graph: the build does not
    depend on shards, and sharing it holds the comparison to the sharded
    search alone. Private state, as ``_share_doc_cache``."""
    from repro_torch.core import vamana
    from repro_torch.distributed import sharding
    from repro_torch.serve import BiMetricEngine

    build = vamana.build
    if src.index is not None:
        vamana.build = lambda *a, **k: src.index
    try:
        eng = BiMetricEngine(
            src.cheap, src.expensive, src.corpus_tokens,
            tower_batch=src.tower_batch, slots=src.slots, shards=shards,
            mesh=sharding.search_mesh(shards, devices=[src.device] * shards),
            device=src.device, **kw)
    finally:
        vamana.build = build
    _share_doc_cache(src, eng)
    return eng


def serve_sharded(eng, ct, reqs, res_b, res_e, wait, rehearse):
    """(h) The engine at ``shards > 1`` on S copies of the card, each
    engine warm from (b)'s D cache: S=4 under ``dedup="auto"`` and
    ``"bitmap"`` (the sync drive, then the async slot drive, of all
    requests), S=3 (2,048 rows: one pad row; sync), the cover-tree engine
    at S=4 (sync and async, the first requests) and 9(d)'s transient drain
    faults at S=4. Every answer bit-equal to the shards=1 drives ((b),
    (e)). Launches are counted over (h) alone: a vamana engine's stage 1
    launches ``gather_score_local`` S times a wave (its waves: merges
    less the stage-2 waves, which are the ``gather_score`` launches on the
    warm D cache); the cover tree none."""
    from repro_torch.kernels import l2_topk
    from repro_torch.serve import FaultPlan, FaultSpec

    sync = torch.cuda.synchronize if eng.device.type == "cuda" else (
        lambda: None)
    few = len(res_e)
    runs = []
    l2_topk.reset_launches()  # the sharded serving path starts here

    def drive(name, e, shards, which, want, fn):
        before = dict(l2_topk.launches)
        t0 = time.perf_counter()
        got = fn()
        sync()
        dt = time.perf_counter() - t0
        delta = {kk: l2_topk.launches[kk] - before[kk] for kk in before}
        _same_results(got, want, f"(h) {name} S={shards} {which}")
        stage2 = delta["gather_score"]
        stage1 = delta["beam_merge_topk"] - stage2
        if not rehearse:
            if e.index_kind == "covertree":
                require(delta["gather_score_local"] == 0 and stage1 == 0,
                        f"(h) {name} {which}: launches {delta}")
            else:
                require(stage1 > 0 and stage2 > 0 and
                        delta["gather_score_local"] == shards * stage1,
                        f"(h) {name} {which}: launches {delta}")
        run = dict(engine=name, S=shards, drive=which, s=dt,
                   requests_per_s=len(got) / dt, launches=delta,
                   stage1_waves=stage1, stage2_waves=stage2)
        log(f"  (h) {name} S={shards} {which}: {dt:.3f} s, "
            f"{run['requests_per_s']:.3f} requests/s, launches {delta}, "
            "bit-equal to shards=1")
        runs.append(run)

    def both(name, e, shards, sub, want):
        drive(name, e, shards, "sync", want, lambda: e.query_batch(sub))
        drive(name, e, shards, "async", want,
              lambda: [f.result(timeout=wait) for f in
                       [e.submit(r) for r in sub]])

    for dedup in ("auto", "bitmap"):
        e = _sharded_engine(eng, 4, dedup=dedup)
        both(f"vamana {dedup}", e, 4, reqs, res_b)
        if dedup == "auto":
            # 9(d)'s transient faults, set on the warm engine as (d) does
            plan = FaultPlan(seed=5, drain=FaultSpec(rate=0.3, burst=2))
            e._faults = plan
            retries0 = e.counters().retries
            drive("vamana auto, transient faults", e, 4, "async",
                  res_b[:few], lambda: [f.result(timeout=wait) for f in
                                        [e.submit(r) for r in reqs[:few]]])
            retries = e.counters().retries - retries0
            require(retries > 0 and plan.fired("drain") > 0,
                    "(h) transient faults: nothing fired or was retried")
            runs[-1].update(fired=plan.fired("drain"), retries=retries)
        e.close(timeout=wait)
    e = _sharded_engine(eng, 3)
    drive("vamana auto", e, 3, "sync", res_b, lambda: e.query_batch(reqs))
    e.close(timeout=wait)
    e = _sharded_engine(ct, 4, index="covertree")
    both("cover tree", e, 4, reqs[:few], res_e)
    e.close(timeout=wait)
    launches = dict(l2_topk.launches)  # read just after (h)
    if not rehearse:
        require(launches["gather_score_local"] > 0,
                "gather_score_local was never launched on phase 9(h)'s path")
    log(f"  (h) launches over (h): {launches}")
    return dict(runs=runs, launches=launches)


def serve_sharded_waves(eng, q_d, batches):
    """(h, after its counts) The sharded engines' stage-1 wave held shard
    by shard: an expansion wave (K = R, the graph rows of random vertices)
    on the cheap embeddings, at each B of ``batches`` (the slot drive's
    and the sync drive's), over the engine's row blocks at S = 4 and S = 3
    (``shard_corpus`` of the cheap rows, as ``sharded_greedy_search`` cuts
    them). Each shard's ``gather_score_local`` must equal its plain
    version within phase 2's f32 limit, give +0.0 on foreign and padding
    lanes and ``gather_score``'s value on owned lanes; the shards' sum
    (padding back to +inf) must be ``gather_score``'s wave bit for bit.
    Returns one row per (S, B) with its max error."""
    from repro_torch.distributed import sharding
    from repro_torch.kernels import backend, l2_topk

    require(eng._view_d is None and not eng.backend.matmul,
            "(h) waves: stage 1 is not on raw f32 rows")
    rng = np.random.default_rng(23)
    dev, n, metric = eng.device, eng.n, eng._metric_d
    corpus = eng.emb_d
    view = backend.as_corpus_view(corpus)
    out = []
    for shards in (4, 3):
        stacked, n_local = sharding.shard_corpus(corpus, shards)
        for b in batches:
            q = q_d[:b].contiguous()
            ids = eng._adjacency[torch.from_numpy(
                rng.integers(0, n, b)).to(dev)].contiguous()
            full = l2_topk.gather_score(corpus, q, ids, metric=metric)
            scale = _term_scale(view, q, ids, metric)
            where = f"(h) stage-1 wave S={shards} B={b} K={ids.shape[1]}"
            total, max_err = None, 0.0
            for sh in range(shards):
                off = sh * n_local
                blk = stacked[sh]
                got = l2_topk.gather_score_local(blk, q, ids, off,
                                                 metric=metric)
                want = l2_topk.gather_score_local_plain(blk, q, ids, off,
                                                        metric=metric)
                owned = (ids >= 0) & (ids - off >= 0) & (ids - off < n_local)
                require(bool((got[~owned].view(torch.int32) == 0).all()),
                        f"{where} s={sh}: foreign lane")
                require(torch.equal(got[owned], full[owned]),
                        f"{where} s={sh}: owned lane != gather_score")
                err = (got[owned] - want[owned]).abs()
                lim = 1e-5 * torch.maximum(want[owned].abs(), scale[owned])
                require(bool((err <= lim).all()),
                        f"{where} s={sh}: max err {float(err.max()):.3e}")
                if err.numel():
                    max_err = max(max_err, float(err.max()))
                total = got if total is None else total + got
            total = torch.where(ids >= 0, total, torch.inf)
            require(torch.equal(total, full),
                    f"{where}: shard sum != gather_score")
            out.append(dict(S=shards, B=b, K=int(ids.shape[1]),
                            dim=int(corpus.shape[1]), n_local=n_local,
                            live_lanes=float((ids >= 0).float().mean()),
                            gather_max_abs_err=max_err))
            log(f"  {where} dim {corpus.shape[1]}: gather_score_local "
                f"max err {max_err:.3e}, shard sum == gather_score")
        del stacked
    return out


def serve_slice(dev, ph8, sizes, rehearse):
    """Phase 9: ``BiMetricEngine`` on phase 8's towers, docs and queries.
    (a) batch-free embeddings; (b) the sync drive from an empty doc cache;
    (c) the async slot drive from an empty cache, bit-equal to (b); (d)
    transient drain faults (bit-equal) and a persistent outage under
    ``degrade`` (the stage-1 proxy ranking), on the warm cache; (e) the
    cover-tree engine, sync = async; (f) the re-rank baseline; launches
    counted over (b)-(f); (g) the path's wave shapes against the plain
    versions; (h) the engines at shards > 1, bit-equal to (b) and (e),
    their launches counted over (h), then their stage-1 wave held shard by
    shard."""
    import dataclasses

    from repro_torch.configs.bimetric_paper import PAPER_DISKANN
    from repro_torch.core import beam, distances, metrics
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import l2_topk
    from repro_torch.serve import (BiMetricEngine, FaultPlan, FaultSpec,
                                   SearchRequest)

    sv = sizes["serve"]
    towers, docs, emb = ph8["towers"], ph8["docs"], ph8["emb"]
    k, batch = ph8["k"], ph8["batch"]
    n, seq = docs.shape
    n_q, n_f, slots, wait = sv["queries"], sv["few"], sv["slots"], sv["wait"]
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    # the slot pool admits token rows of the corpus's length only (as the
    # JAX engine does), so phase 9 draws its queries as launch/serve.py
    # does: a doc with its first half redrawn, numpy seed 22
    rng = np.random.default_rng(22)
    queries = docs[rng.integers(0, n, n_q)].copy()
    queries[:, :seq // 2] = rng.integers(
        0, min(t.cfg.vocab for t in towers.values()), (n_q, seq // 2))
    out = dict(N=n, queries=n_q, query_len=seq, slots=slots,
               quotas=sv["quotas"], tower_batch=batch)
    out["batch_free"], q_emb = batch_free(towers, docs, queries, emb, batch,
                                          n_f)

    timed = _TimedTower(towers["expensive"], docs)
    reqs = [SearchRequest(tokens=queries[i], quota=sv["quotas"][i % 2], k=k,
                          priority=i % 3) for i in range(n_q)]
    quota = np.array([r.quota for r in reqs])
    em_D = distances.EmbeddingMetric(emb["expensive", "docs"])
    true_ids, _ = em_D.brute_force(q_emb["expensive"], k)
    fa.reset_launches()
    l2_topk.reset_launches()  # the path starts here
    t0 = time.perf_counter()
    cfg = PAPER_DISKANN._replace(build_batch=min(PAPER_DISKANN.build_batch,
                                                 n))
    eng = BiMetricEngine(towers["cheap"], timed, docs, index_cfg=cfg,
                         tower_batch=batch, slots=slots, device=dev)
    sync()
    out["engine_s"] = time.perf_counter() - t0

    def run_stats(res, dt):
        for r, q in zip(res, quota):
            require(r.stats.D_calls <= q, f"D_calls {r.stats.D_calls} > {q}")
            require(len(r.ids) == min(k, q) and np.isfinite(r.dists).all(),
                    "serve: short or non-finite result row")
        ids = np.full((len(res), k), -1, np.int64)
        for i, r in enumerate(res):
            ids[i, :len(r.ids)] = r.ids
        rec = metrics.recall_at_k(torch.from_numpy(ids),
                                  true_ids.cpu().long()[:len(res)])
        row = dict(s=dt, requests_per_s=len(res) / dt,
                   d_calls_mean=float(np.mean([r.stats.d_calls
                                               for r in res])),
                   doc_batches=timed.doc_batches, docs_embedded=timed.doc_rows,
                   docs_per_batch=timed.doc_rows / max(timed.doc_batches, 1),
                   D_s=timed.seconds, D_share=timed.seconds / dt)
        for q in sv["quotas"]:
            sel = quota[:len(res)] == q
            row[f"Q{q}"] = dict(
                recall_at_10=float(rec[torch.from_numpy(sel)].mean()),
                D_calls_mean=float(np.mean([r.stats.D_calls for r, s in
                                            zip(res, sel) if s])))
        return row

    # (b) the sync drive, from an empty doc cache
    timed.reset()
    t0 = time.perf_counter()
    res_b = eng.query_batch(reqs)
    sync()
    out["sync"] = run_stats(res_b, time.perf_counter() - t0)
    out["sync"]["tower_batches"] = res_b[0].stats.tower_batches
    log(f"  (b) sync: {json.dumps(out['sync'])}")

    # (c) the async slot drive, from an empty doc cache again
    eng.reset_doc_cache()
    timed.reset()
    t0 = time.perf_counter()
    futs = [eng.submit(r) for r in reqs]
    res_c = [f.result(timeout=wait) for f in futs]
    out["async"] = run_stats(res_c, time.perf_counter() - t0)
    _same_results(res_c, res_b, "async drive")
    out["async"].update(
        latency_ms=_pct([r.stats.latency_ms for r in res_c]),
        queue_ms=_pct([r.stats.queue_ms for r in res_c]),
        compute_ms=_pct([r.stats.compute_ms for r in res_c]),
        counters=dataclasses.asdict(eng.counters()))
    log(f"  (c) async = sync bit for bit: {json.dumps(out['async'])}")

    # (d) faults on the warm cache. The engine takes faults= when it is
    # built; they are set on this one so that it keeps its warm cache.
    sub = reqs[:n_f]
    burst = 2  # at most tower_retries: every burst is recovered
    require(burst <= eng.tower_retries)
    plan = FaultPlan(seed=5, drain=FaultSpec(rate=0.3, burst=burst))
    eng._faults = plan
    before = eng.counters()
    t0 = time.perf_counter()
    res_d = [f.result(timeout=wait) for f in [eng.submit(r) for r in sub]]
    dt = time.perf_counter() - t0
    _same_results(res_d, res_b[:n_f], "transient drain faults")
    retries = eng.counters().retries - before.retries
    require(retries > 0 and plan.fired("drain") > 0,
            "transient faults: nothing fired or was retried")
    out["transient"] = dict(s=dt, fired=plan.fired("drain"),
                            retries=retries)
    eng._faults = FaultPlan(seed=6, drain=FaultSpec(rate=1.0,
                                                    mode="persistent"))
    eng.on_tower_failure = "degrade"
    t0 = time.perf_counter()
    res_g = [f.result(timeout=wait) for f in [eng.submit(r) for r in sub]]
    dt = time.perf_counter() - t0
    require(all(r.stats.degraded for r in res_g),
            "persistent faults: a request was not degraded")
    out["degrade"] = dict(s=dt, health=eng.health())
    eng._faults = None
    eng.on_tower_failure = "fail"
    log(f"  (d) transient faults bit-equal: {json.dumps(out['transient'])}; "
        f"persistent, degrade: {dt:.3f} s (held to the proxy rankings after "
        f"the counts); health {json.dumps(out['degrade']['health'])}")

    # (e) the cover tree: sync = async on the warm cache
    t0 = time.perf_counter()
    ct = BiMetricEngine(towers["cheap"], timed, docs, index="covertree",
                        tower_batch=batch, slots=slots, device=dev)
    sync()
    build_s = time.perf_counter() - t0
    _share_doc_cache(eng, ct)
    t0 = time.perf_counter()
    res_e = ct.query_batch(sub)
    sync_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res_ea = [f.result(timeout=wait) for f in [ct.submit(r) for r in sub]]
    async_s = time.perf_counter() - t0
    _same_results(res_ea, res_e, "cover-tree async drive")
    for r, q in zip(res_e, quota):
        require(r.stats.D_calls <= q and len(r.ids) > 0,
                f"cover tree: D_calls {r.stats.D_calls} > {q} or empty")
    out["covertree"] = dict(
        engine_s=build_s, depth=ct._flat.depth, sync_s=sync_s,
        async_s=async_s,
        D_calls_mean=float(np.mean([r.stats.D_calls for r in res_e])))
    log(f"  (e) cover tree, async = sync: {json.dumps(out['covertree'])}")

    # (f) the re-rank baseline
    t0 = time.perf_counter()
    ids_f, dd_f, st_f = eng.rerank_query_batch(queries[:n_f],
                                               quota=sv["rerank_q"], k=k)
    sync()
    require(all(s.D_calls <= sv["rerank_q"] for s in st_f)
            and np.isfinite(dd_f).all(), "rerank: over quota or non-finite")
    out["rerank"] = dict(s=time.perf_counter() - t0, Q=sv["rerank_q"],
                         D_calls_max=max(s.D_calls for s in st_f))
    launches = dict(**fa.launches, **l2_topk.launches)  # just after (b)-(f)
    out["launches"] = launches
    log(f"  (f) rerank: {json.dumps(out['rerank'])}; launches over (b)-(f) "
        f"{launches}")
    if not rehearse:
        for name in ("gather_score", "beam_merge_topk",
                     "flash_attention_wgmma", "flash_attention_simt"):
            require(launches[name] > 0, f"{name} was never launched on "
                                        "phase 9's path")

    # (d, after the counts) each degraded request is its stage-1 proxy
    # ranking, as the slot pool runs it (per-row width max(32, Q/2) and 4x
    # its steps, from the medoid); this reference search launches the
    # search kernels, so it runs after the path's counts are read
    nseed = np.maximum(1, quota[:n_f] // 2)
    width = np.maximum(32, nseed).astype(np.int32)
    proxy = beam.batched_greedy_search(
        distances.EmbeddingMetric(eng.emb_d).dists_batch,
        eng.index.adjacency, q_emb["cheap"][:n_f],
        torch.full((n_f, 1), int(eng.index.medoid), dtype=torch.int32,
                   device=dev), n_points=n, beam_width=width,
        pool_size=int(width.max()), max_steps=4 * width)
    for i, r in enumerate(res_g):
        want = proxy.pool_ids[i, :k].cpu().numpy()
        require(np.array_equal(r.ids, want[want >= 0]),
                f"degraded request {i} is not its proxy ranking")
    log("  (d) every degraded request is its stage-1 proxy ranking")

    # (g) the path's wave shapes held against the plain versions
    out["wave_check"] = serve_waves(
        eng, ct, {name: e[:slots] for name, e in q_emb.items()},
        sv["quotas"], k)

    # (h) shards > 1, bit-equal to (b) and (e)
    out["sharded"] = serve_sharded(eng, ct, reqs, res_b, res_e, wait,
                                   rehearse)
    out["sharded"]["wave_check"] = serve_sharded_waves(
        eng, q_emb["cheap"], (slots, n_q))
    ct.close(timeout=wait)
    eng.close(timeout=wait)
    return out


# --------------------------------------------------------------------------
# phase 10: scatter-gather search over per-shard sub-indices
# --------------------------------------------------------------------------
SG_SHARDS = 4  # phase 5's shard count, on the one card


def _host_index(idx):
    """A copy on the CPU of a ``ShardedIndex`` (the same graphs)."""
    return idx._replace(**{f: tuple(t.cpu() for t in getattr(idx, f))
                           for f in ("adjacency", "emb_cheap",
                                     "emb_expensive")})


def scatter_gather_cross(dev, n, dim_d, dim_D, n_queries, quotas):
    """At phase 3's size and data, four graphs built on the card by
    ``build_sharded`` are searched on the card and, copied, with
    ``device="cpu"``: each shard's answer (ids, D calls) must agree up to a
    near-tie (phase 3's rule, ``_explain`` on that shard), and a query
    whose shards all agree must get the same merged ids and total."""
    from repro_torch.configs.bimetric_paper import PAPER_DISKANN
    from repro_torch.core import distances
    from repro_torch.core import distributed as sg
    from repro_torch.core.vamana import VamanaIndex
    from repro_torch.data.synthetic import make_dataset, proxy_quality_sweep
    from repro_torch.distributed import sharding

    cpu = torch.device("cpu")
    noise = {k: v for k, v in proxy_quality_sweep("bge-micro-like").items()
             if k != "dim_d"}
    data = make_dataset(n=n, n_queries=n_queries, dim_D=dim_D, dim_d=dim_d,
                        n_clusters=n // POINTS_PER_CLUSTER, seed=3,
                        device=dev, **noise)
    s_n, k = SG_SHARDS, 10
    nl = n // s_n
    cfg = PAPER_DISKANN._replace(build_batch=min(PAPER_DISKANN.build_batch,
                                                 nl))
    one = torch.device("cuda", 0) if dev.type == "cuda" else dev
    mesh = sharding.search_mesh(s_n, devices=[one] * s_n)
    host_mesh = sharding.search_mesh(s_n, devices=[cpu] * s_n)
    t0 = time.perf_counter()
    idx = sg.build_sharded(data.corpus_d, data.corpus_D, s_n, cfg, mesh=mesh)
    log(f"  cross-check build_sharded N={n}, S={s_n}: "
        f"{time.perf_counter() - t0:.3f} s")
    host = _host_index(idx)
    q_host = {f: getattr(data, f).cpu() for f in ("queries_d", "queries_D")}
    allowed = []
    for q in quotas:
        per = max(k, q // s_n)
        agree = torch.ones(n_queries, dtype=torch.bool)
        for s in range(s_n):
            sides = []
            for ix, d, qd, qD in ((idx, one, data.queries_d, data.queries_D),
                                  (host, cpu, q_host["queries_d"],
                                   q_host["queries_D"])):
                sides.append(dict(
                    cd=ix.emb_cheap[s], cD=ix.emb_expensive[s], qd=qd, qD=qD,
                    adj=ix.adjacency[s],
                    res=sg._local_search(
                        ix.adjacency[s], ix.medoid[s], ix.emb_cheap[s],
                        ix.emb_expensive[s], qd, qD, quota=per, k=k,
                        n_seeds=max(1, per // 2), cfg=cfg, device=d)))
            gpu, hst = sides
            for side in sides:
                side["fd"] = distances.EmbeddingMetric(side["cd"]).dists_batch
                side["fD"] = distances.EmbeddingMetric(side["cD"]).dists_batch
            (ia, da, ca), (ic, dc, cc) = gpu["res"], hst["res"]
            require(int(ca.max()) <= per, f"shard {s}: D calls past {per}")
            for b in range(n_queries):
                if (torch.equal(ia[b].cpu(), ic[b])
                        and int(ca[b]) == int(cc[b])):
                    torch.testing.assert_close(da[b].cpu(), dc[b], rtol=1e-4,
                                               atol=1e-4)
                    continue
                agree[b] = False
                sub = [VamanaIndex(adjacency=x["adj"], medoid=idx.medoid[s],
                                   config=cfg) for x in sides]
                stage, gap, pair = _explain(b, "bimetric", per, gpu, hst,
                                            *sub, nl, None, None)
                ok = gap <= CROSS_RTOL
                log(f"  query {b} (Q={q}, shard {s}) differs at {stage}: "
                    f"candidates {pair}, relative gap {gap:.3e} "
                    f"({'near-tie, allowed' if ok else 'NOT a near-tie'})")
                require(ok, f"query {b} shard {s} differs beyond a near-tie")
                allowed.append(dict(Q=q, shard=s, query=b, stage=stage,
                                    gap=gap))
        got = sg.sharded_bimetric_search(mesh, idx, data.queries_d,
                                         data.queries_D, quota=q, k=k)
        want = sg.sharded_bimetric_search(host_mesh, host,
                                          q_host["queries_d"],
                                          q_host["queries_D"], quota=q, k=k)
        for b in agree.nonzero().flatten().tolist():
            require(torch.equal(got[0][b].cpu(), want[0][b])
                    and int(got[2][b]) == int(want[2][b]),
                    f"query {b} (Q={q}): shards agree, the merge differs")
            torch.testing.assert_close(got[1][b].cpu(), want[1][b], rtol=1e-4,
                                       atol=1e-4)
    log(f"  scatter-gather card vs cpu: {n_queries} queries x {len(quotas)} "
        f"quotas x {s_n} shards, {len(allowed)} near-tie differences")
    return dict(near_ties=allowed)


def check_ring_matmuls(dev, rehearse):
    """The ring matmuls over four shards on the one card against one dense
    ``torch.matmul`` (f32, unit-scale products), within 1e-4."""
    from repro_torch.distributed import collectives

    s_n = SG_SHARDS
    m, kk, n = (64, 48, 32) if rehearse else (1024, 384, 256)
    g = torch.Generator(device=dev).manual_seed(20)
    x = torch.randn(m, kk, generator=g, device=dev)
    w = torch.randn(kk, n, generator=g, device=dev) / math.sqrt(kk)
    gathered = collectives.allgather_matmul(list(x.chunk(s_n)), [w] * s_n)
    scattered = torch.cat(collectives.matmul_reducescatter(
        list(x.chunk(s_n, dim=1)), list(w.chunk(s_n))))
    dense = torch.matmul(x, w)
    errs = dict(allgather_matmul=max(float((o - dense).abs().max())
                                     for o in gathered),
                matmul_reducescatter=float((scattered - dense).abs().max()))
    for name, e in errs.items():
        require(e <= 1e-4, f"{name}: max |ring - dense| {e:.3e}")
    log(f"  ring matmuls ({m}x{kk} @ {kk}x{n}, {s_n} shards) vs torch.matmul: "
        f"{json.dumps(errs)}")
    return dict(shape=(m, kk, n), max_abs_err=errs)


def scatter_gather_slice(dev, ph4, diskann_runs, quotas, rehearse):
    """Phase 10: ``core/distributed.py`` on phase 4's data. ``build_sharded``
    builds S=4 graphs of N/4 rows on d (timed), ``sharded_bimetric_search``
    runs at each Q, recall@10 / nDCG@10 beside phase 4's bi-metric runs;
    launches counted over the build and the searches. After the counts,
    each shard searched alone by ``bimetric_search`` at the per-shard quota
    and seeds: its D calls within max(k, Q // S), the merge of the shards'
    answers the entry point's, and the d calls summed over the shards."""
    from repro_torch.configs.bimetric_paper import PAPER_DISKANN
    from repro_torch.core import bimetric, distances, metrics
    from repro_torch.core import distributed as sg
    from repro_torch.core.vamana import VamanaIndex
    from repro_torch.distributed import collectives, sharding
    from repro_torch.kernels import l2_topk

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    data, k, true_ids = ph4["data"], ph4["k"], ph4["true_ids"]
    n, n_queries = data.corpus_d.shape[0], data.queries_d.shape[0]
    s_n = SG_SHARDS
    require(n % s_n == 0, f"N={n} does not divide into {s_n} shards")
    nl = n // s_n
    one = torch.device("cuda", 0) if dev.type == "cuda" else dev
    mesh = sharding.search_mesh(s_n, devices=[one] * s_n)
    cfg = PAPER_DISKANN._replace(build_batch=min(PAPER_DISKANN.build_batch,
                                                 nl))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    out = dict(N=n, S=s_n, n_local=nl)
    l2_topk.reset_launches()  # the path starts here
    t0 = time.perf_counter()
    idx = sg.build_sharded(data.corpus_d, data.corpus_D, s_n, cfg, mesh=mesh)
    sync()
    out["build_s"] = time.perf_counter() - t0
    out["build_launches"] = dict(l2_topk.launches)
    require(all(idx.emb_cheap[s].data_ptr()
                == data.corpus_d[s * nl:].data_ptr() for s in range(s_n)),
            "shard rows are not views of the corpus")
    log(f"  build_sharded N={n}, S={s_n} ({nl} rows a shard): "
        f"{out['build_s']:.3f} s, launches {out['build_launches']}")
    runs, results = [], {}
    for q in quotas:
        before = dict(l2_topk.launches)
        t0 = time.perf_counter()
        ids, dists, calls = sg.sharded_bimetric_search(
            mesh, idx, data.queries_d, data.queries_D, quota=q, k=k)
        sync()
        dt = time.perf_counter() - t0
        per = max(k, q // s_n)
        require(ids.shape == (n_queries, k) and dists.shape == (n_queries, k))
        require(bool(torch.isfinite(dists).all()) and bool((ids >= 0).all()))
        require(int(calls.max()) <= s_n * per, (q, int(calls.max())))
        results[q] = (ids, dists, calls)
        base = next(r for r in diskann_runs
                    if r["method"] == "bimetric" and r["Q"] == q)
        run = dict(Q=q, per_shard_quota=per, query_s=dt, qps=n_queries / dt,
                   recall_at_10=float(metrics.recall_at_k(ids, true_ids)
                                      .mean()),
                   ndcg_at_10=float(metrics.ndcg_at_k(ids, true_ids).mean()),
                   mean_D_calls=float(calls.float().mean()),
                   max_D_calls=int(calls.max()),
                   unsharded_recall_at_10=base["recall_at_10"],
                   unsharded_ndcg_at_10=base["ndcg_at_10"],
                   unsharded_query_s=base["query_s"],
                   unsharded_mean_d_calls=base["mean_d_calls"],
                   launches={kk: l2_topk.launches[kk] - before[kk]
                             for kk in before})
        log(f"  scatter-gather Q={q:5d} ({per} a shard): {dt:.3f} s, "
            f"{run['qps']:.1f} q/s, recall@10 {run['recall_at_10']:.4f}, "
            f"nDCG@10 {run['ndcg_at_10']:.4f} (unsharded bi-metric "
            f"{base['recall_at_10']:.4f} / {base['ndcg_at_10']:.4f} in "
            f"{base['query_s']:.3f} s), D_calls mean "
            f"{run['mean_D_calls']:.1f} max {run['max_D_calls']}, launches "
            f"{run['launches']}")
        runs.append(run)
    launches = dict(l2_topk.launches)  # read just after the path
    out.update(runs=runs, launches=launches)
    if dev.type == "cuda":
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        log(f"  max_memory_allocated {out['max_memory_allocated']} bytes")
    require(launches["gather_score_local"] == 0,
            "gather_score_local launched on the scatter-gather path")
    if not rehearse:
        for name in ("gather_score", "beam_merge_topk"):
            require(launches[name] > 0,
                    f"{name} was never launched on phase 10's path")

    # after the counts: each shard alone, within its quota, and the merge
    # of the shards' answers is the entry point's, bit for bit
    for q, run in zip(quotas, runs):
        per = max(k, q // s_n)
        gids, gd, total, d_calls = [], [], 0, 0
        for s in range(s_n):
            res = bimetric.bimetric_search(
                distances.EmbeddingMetric(idx.emb_cheap[s]).dists_batch,
                distances.EmbeddingMetric(idx.emb_expensive[s]).dists_batch,
                VamanaIndex(idx.adjacency[s], idx.medoid[s], cfg),
                data.queries_d, data.queries_D, n_points=nl, quota=per, k=k,
                n_seeds=max(1, per // 2), device=one)
            require(int(res.D_calls.max()) <= per,
                    f"Q={q} shard {s}: {int(res.D_calls.max())} D calls "
                    f"past {per}")
            gids.append(torch.where(res.ids >= 0, res.ids + s * nl, -1))
            gd.append(torch.where(res.ids >= 0, res.dists, float("inf")))
            total = total + res.D_calls
            d_calls = d_calls + res.d_calls
        mi, md = collectives.gather_topk_merge(gids, gd, k)
        ids, dists, calls = results[q]
        require(torch.equal(mi, ids) and torch.equal(md, dists)
                and torch.equal(total, calls),
                f"Q={q}: the shards' merge is not the entry point's answer")
        run["mean_d_calls"] = float(d_calls.float().mean())
        log(f"  Q={q}: d calls mean {run['mean_d_calls']:.1f} summed over "
            f"the shards (unsharded {run['unsharded_mean_d_calls']:.1f})")
    log("  each shard within max(k, Q // 4) D calls; the merge of the "
        "shards' answers equals the entry point's")
    out["rings"] = check_ring_matmuls(dev, rehearse)
    return out


# --------------------------------------------------------------------------
# phase 11: training the d tower
# --------------------------------------------------------------------------
# the backward kernel against its plain version on the same card inputs:
# within tol x the largest |gradient| (f32 sums of up to S products in
# another order; a 16-bit gradient is rounded once on either side); fixed
# before the first run, as the card tests' BWD_TOL
BWD_TOL = {F32: 1e-5, BF16: 2e-2, F16: 2e-3}
# B, H, Sq, Skv, dh, dv, causal, dtype, role: d's training layer and D's
# layer (32 query heads; the kernel sees the 8 KV heads repeated), timed;
# then the edges: non-causal and causal Sq < Skv, Sq > Skv (rows with no
# key), dv != dh, the 32-row tiles (MLA's 192/128, 256) and f16; then the
# tensor-core routes' tile edges (Sq, Skv one past a tile or short of it,
# Sq > Skv under causal masking, padded widths) and heads they leave to the
# SIMT kernel. Each row runs the route _backward_route picks for it.
BWD_CASES = [
    (64, 6, 256, 256, 64, 64, True, F32, "d (bge-micro-like) training layer"),
    (4, 32, 256, 256, 128, 128, True, BF16, "D (sfr-mistral-7b) layer"),
    (2, 3, 37, 100, 64, 64, False, F32, None),
    (2, 3, 37, 100, 64, 64, True, BF16, None),
    (2, 2, 100, 37, 64, 64, True, F32, None),
    (1, 2, 70, 70, 48, 32, True, F32, None),
    (1, 2, 70, 90, 192, 128, True, BF16, None),
    (1, 2, 50, 80, 256, 256, False, F16, None),
    (2, 2, 65, 65, 128, 128, True, F16, None),
    (1, 2, 130, 75, 128, 128, True, F32, None),
    (1, 2, 67, 131, 96, 64, False, F32, None),
    (2, 2, 150, 90, 64, 64, True, BF16, None),
    (1, 3, 200, 333, 40, 24, True, F16, None),
    (1, 2, 129, 129, 128, 64, False, BF16, None),
    (1, 2, 45, 61, 20, 12, True, F32, None),
    (1, 2, 40, 40, 160, 64, True, F32, None),
]


def _valid_pairs(sq, skv, causal):
    if not causal:
        return sq * skv
    off = skv - sq
    return sum(max(0, min(skv, i + off + 1)) for i in range(sq))


def _bwd_bound(route, dt, nbytes, pairs, dh, dv):
    """(ms, "bytes" or "operations") of the backward's function (five
    products of 2 d flops per valid pair) at the rate of the route's
    operations: three TF32 products each on the tf32 route, the 16-bit
    tensor-core rate on wgmma, the f32 rate outside the tensor cores on
    SIMT (and for 16-bit SIMT, the tensor-core rate the inputs allow)."""
    flops = 2 * (3 * dh + 2 * dv) * pairs
    if route == "tf32":
        return bound(nbytes, 3 * flops, TF32_OPS_PER_S)
    return bound(nbytes, flops, _ops_rate(dt))


def _device_split(fn, n=20):
    """Device ms per call of each CUDA kernel ``fn`` launches, from
    ``torch.profiler`` over ``n`` calls (kernel names cut to 80
    characters), and how many launches of each the profile recorded. The
    profile drops some records (14-15 of 20 launches on that machine), so
    a kernel's ms per call is its mean over the launches recorded times
    its launches a call, taken as its count over the least count (every
    ``fn`` here launches some kernel once a call); ``{"error": ...}``
    where the profiler reports nothing."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    totals, counts = {}, {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = getattr(ev, "cuda_time_total", 0)
        if t and ev.count:
            totals[ev.key[:80]] = t
            counts[ev.key[:80]] = ev.count
    if not totals:
        return {"error": "no device time in the profile"}, {}
    least = min(counts.values())
    split = {k: totals[k] / counts[k] * max(1, round(counts[k] / least))
             / 1e3 for k in totals}
    return split, counts


def _sdpa_backward(q, k, v, dout, causal):
    """SDPA's backward timed alone: its graph built once, then only
    ``autograd.grad(o, leaves, dout, retain_graph=True)`` between the
    events; the backend that ran (from the graph's node), the spread of
    the windows and the kernels' device time from the profiler; beside it
    the older reading, forward + backward less the forward."""
    import torch.nn.functional as F

    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    o = F.scaled_dot_product_attention(*leaves, is_causal=causal)
    ms, lo, hi = time_ms(lambda: torch.autograd.grad(
        o, leaves, dout, retain_graph=True), spread=True)
    out = dict(library="F.scaled_dot_product_attention backward alone "
                       "(autograd.grad on a graph built once)",
               library_backend=type(o.grad_fn).__name__, library_ms=ms,
               library_ms_min=lo, library_ms_max=hi)
    # the kernels' device time alone, without the autograd engine's host work
    split, counts = _device_split(lambda: torch.autograd.grad(
        o, leaves, dout, retain_graph=True))
    out["library_device_split_ms"] = split
    out["library_device_split_counts"] = counts
    if "error" not in split:
        out["library_device_ms"] = sum(split.values())

    def fwd_bwd():
        x = F.scaled_dot_product_attention(*leaves, is_causal=causal)
        return torch.autograd.grad(x, leaves, dout)

    with torch.no_grad():
        fwd_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal))
    out["library_fwd_bwd_ms"] = time_ms(fwd_bwd)
    out["library_fwd_bwd_less_fwd_ms"] = out["library_fwd_bwd_ms"] - fwd_ms
    del o, leaves
    return out


def check_attention_backward(dev, rehearse):
    """``flash_attention_bwd`` against ``flash_attention_bwd_plain`` on the
    same card inputs (out and each row's log-sum-exp from the forward
    kernel, as autograd saves them; a seeded cotangent) at
    :data:`BWD_CASES`, each on the route ``_backward_route`` picks (its
    counter must move), bit-equal on a second call (no atomics). The timed
    rows: the route with the forward's log-sum-exp (the training path) and
    without it, the SIMT kernel on the same inputs (with and without),
    beside the bound of the
    route's operations (and the f32 bound of the SIMT kernel), the plain
    version, and SDPA's backward timed alone. Returns (rows, max error)."""
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(23)
    rows, worst = [], 0.0
    for b, h, sq, skv, dh, dv, causal, dt, role in BWD_CASES:
        if rehearse:
            b, h, sq, skv = 1, 2, min(sq, 24), min(skv, 24)
        route = fa._backward_route(dt, dh, dv)
        q, k, v = _attn_inputs(g, dev, b, h, sq, skv, dh, dv, dt)
        dout = torch.randn(b, h, sq, dv, generator=g, device=dev).to(dt)
        with torch.inference_mode():
            out, lse = fa.flash_attention_lse(q, k, v, causal=causal)
        key = f"flash_attention_bwd_{route}"
        before = fa.launches[key]
        got = fa.flash_attention_bwd(q, k, v, out, dout, causal=causal,
                                     lse=lse)
        want = fa.flash_attention_bwd_plain(q, k, v, out, dout, causal=causal)
        what = f"flash_attention_bwd {(b, h, sq, skv, dh, dv, causal, dt)}"
        if dev.type == "cuda":
            require(fa.launches[key] == before + 1,
                    f"{what}: not counted under {key}")
        err = 0.0
        for x, w, name in zip(got, want, ("dq", "dk", "dv")):
            require(x.dtype == dt and x.shape == w.shape
                    and bool(torch.isfinite(x.float()).all()),
                    f"{what}: {name} dtype, shape or non-finite values")
            e = float((x.float() - w.float()).abs().max())
            require(e <= BWD_TOL[dt] * float(w.float().abs().max()),
                    f"{what}: {name} max err {e:.3e}")
            err = max(err, e)
        if causal and sq > skv:
            require(bool((got[0][:, :, : sq - skv] == 0).all()),
                    f"{what}: a row with no key has a dq")
        again = fa.flash_attention_bwd(q, k, v, out, dout, causal=causal,
                                       lse=lse)
        require(all(torch.equal(x, y) for x, y in zip(got, again)),
                f"{what}: two calls differ")
        worst = max(worst, err)
        row = dict(role=role, route=route, B=b, H=h, Sq=sq, Skv=skv, dh=dh,
                   dv=dv, causal=causal, dtype=str(dt), max_abs_err=err)
        if role is not None:
            pairs = b * h * _valid_pairs(sq, skv, causal)
            item = q.element_size()
            # q, k, v, out and dout read once; dq, dk, dv written once
            nbytes = item * (2 * (q.numel() + k.numel() + v.numel())
                             + 2 * out.numel())
            row["bound_ms"], row["bound_by"] = _bwd_bound(
                route, dt, nbytes, pairs, dh, dv)
            row["bound_ms_simt"], row["bound_by_simt"] = bound(
                nbytes, 2 * (3 * dh + 2 * dv) * pairs, F32_OPS_PER_S)
            if not rehearse:
                def run(route_=None, lse_=lse):
                    return fa._backward_card(q, k, v, out, dout, causal,
                                             dh ** -0.5, lse_, route_)

                row["ms"], row["ms_min"], row["ms_max"] = time_ms(
                    run, spread=True)
                # the device's time alone: CUDA-graph replay, as for the
                # other kernels; the profiler's split by kernel beside it
                row["device_ms"] = time_graph_ms(run)
                row["device_split_ms"], row["device_split_counts"] = (
                    _device_split(run))
                row["ms_no_lse"] = time_ms(lambda: run(lse_=None))
                if route != "simt":
                    row["simt_ms"] = time_ms(lambda: run("simt"))
                    # the SIMT kernel recomputing the log-sum-exp: eight
                    # products a valid pair, against the route's seven
                    row["simt_no_lse_ms"] = time_ms(
                        lambda: run("simt", None))
                row["plain_ms"] = time_ms(lambda: fa.flash_attention_bwd_plain(
                    q, k, v, out, dout, causal=causal), reps=5, inner=2)
                row.update(_sdpa_backward(q, k, v, dout, causal))
        rows.append(row)
        log("  " + json.dumps(row))
        del q, k, v, out, lse, dout, got, want, again
    return rows, worst


def _wall_s(fn, reps):
    """Median wall seconds of ``fn()`` between two synchronizes."""
    times = []
    for _ in range(reps):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def train_slice(dev, sizes, rehearse):
    """Phase 11: ``Trainer.run`` -> ``info_nce_loss`` -> ``embed_pool``
    under grad -> ``blockwise_attention`` -> the ``flash_attention``
    forward and backward kernels -> AdamW, on the d tower at full width,
    launches counted from 0 over the run; then the grad_accum check and
    the forward / backward / optimizer split."""
    from repro_torch.data.pipeline import (DeterministicIterator,
                                           contrastive_batch_fn)
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer
    from repro_torch.train import contrastive, optimizer, trainer

    tz = sizes["train"]
    cfg = tz["tower"]()
    model = transformer.init_params(tz["seed"], cfg, device=dev)
    make = contrastive_batch_fn(tz["batch"], tz["seq"], cfg.vocab)
    loss_fn = functools.partial(contrastive.info_nce_loss,
                                temperature=tz["temperature"])
    held_out = {k: torch.as_tensor(x).to(dev)
                for k, x in make(tz["seed"] + 99, 0).items()}

    def held_out_losses(m):
        """(loss, acc) at the trained temperature and at the default 0.05,
        on one batch no step sees."""
        with torch.no_grad():
            out = {}
            for t in (tz["temperature"], 0.05):
                loss, aux = contrastive.info_nce_loss(m, held_out,
                                                      temperature=t)
                out[f"T={t}"] = dict(loss=float(loss), acc=float(aux["acc"]))
            return out

    # the cosine over the run's own steps: over 100 (as
    # examples/train_biencoder.py) lr stays near its peak to the end, and the
    # loss of the last 5 steps hardly fell below the first 5's (PERF.md §6)
    opt = optimizer.AdamWConfig(lr=1e-3, warmup_steps=tz["warmup"],
                                total_steps=tz["steps"])
    tcfg = trainer.TrainerConfig(total_steps=tz["steps"], log_every=10)
    out = dict(tower=cfg.name, batch=tz["batch"], seq=tz["seq"],
               steps=tz["steps"], lr=opt.lr, warmup=opt.warmup_steps,
               temperature=tz["temperature"],
               held_out_before=held_out_losses(model))
    if dev.type == "cuda":
        # what earlier phases still hold counts in the peak: report it too
        out["memory_allocated_at_start"] = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    tr = trainer.Trainer(loss_fn, model, opt, tcfg, device=dev)
    fa.reset_launches()  # the path starts here
    t0 = time.perf_counter()
    res = tr.run(DeterministicIterator(make, seed=tz["seed"], device=dev),
                 log=lambda msg: log("    " + msg))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = dict(fa.launches)  # read just after the path
    out["run_s"] = time.perf_counter() - t0
    losses = res["losses"]
    out.update(losses=losses, launches=launches,
               step_ms=[1e3 * t for t in tr.step_times],
               stragglers=res["stragglers"])
    tail = tr.step_times[-20:]
    out["step_ms_median_last20"] = 1e3 * statistics.median(tail)
    tokens = 2 * tz["batch"] * tz["seq"]  # queries and docs
    out["tokens_per_step"] = tokens
    out["tokens_per_s"] = tokens / statistics.median(tail)
    if dev.type == "cuda":
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    log(f"  loss curve {json.dumps([round(x, 6) for x in losses])}")
    log(f"  step {out['step_ms_median_last20']:.3f} ms (median of the last "
        f"20), {out['tokens_per_s']:.0f} tokens/s, launches {launches}, "
        f"max_memory_allocated {out.get('max_memory_allocated')} bytes "
        f"({out.get('memory_allocated_at_start')} at the phase's start)")
    require(all(math.isfinite(x) for x in losses), "a loss is not finite")
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    out["loss_first5"], out["loss_last5"] = first, last
    require(last < first, f"the loss did not fall: first 5 {first:.6g}, "
            f"last 5 {last:.6g}")
    out["held_out_after"] = held_out_losses(tr.params)
    log(f"  held-out batch before {json.dumps(out['held_out_before'])}, "
        f"after {json.dumps(out['held_out_after'])}")
    per_step = 2 * cfg.n_layers  # two towers' passes a step, one per layer
    if not rehearse:
        require(launches["flash_attention_simt"] == per_step * tz["steps"],
                f"simt launches {launches['flash_attention_simt']}")
        require(launches["flash_attention_bwd"] == per_step * tz["steps"],
                f"backward launches {launches['flash_attention_bwd']}")
        # d's f32 heads of 64 take the 3xTF32 tensor-core route
        require(launches["flash_attention_bwd_tf32"]
                == launches["flash_attention_bwd"],
                f"backward launches by route {launches}")

    # the forward / backward / optimizer split at the trained weights
    batch = {k: torch.as_tensor(x).to(dev) for k, x in make(99, 0).items()}
    params = list(tr.params.parameters())
    out["forward_ms"] = 1e3 * _wall_s(lambda: loss_fn(tr.params, batch)[0],
                                      5)
    out["forward_backward_ms"] = 1e3 * _wall_s(
        lambda: torch.autograd.grad(loss_fn(tr.params, batch)[0], params), 5)
    out["backward_ms"] = out["forward_backward_ms"] - out["forward_ms"]
    out["optimizer_and_rest_ms"] = (out["step_ms_median_last20"]
                                    - out["forward_backward_ms"])
    log(f"  split: forward {out['forward_ms']:.3f} ms, backward "
        f"{out['backward_ms']:.3f} ms, optimizer and the rest "
        f"{out['optimizer_and_rest_ms']:.3f} ms")

    # grad_accum=2 against grad_accum=1 on the mean of the halves' losses,
    # both from the trained weights on the same batches
    half = tz["batch"] // 2

    def halves_loss(m, b):
        la = loss_fn(m, {k: x[:half] for k, x in b.items()})
        lb = loss_fn(m, {k: x[half:] for k, x in b.items()})
        return (la[0] + lb[0]) / 2, {}

    accum = {}
    for name, fn, ga in (("grad_accum=2", loss_fn, 2),
                         ("grad_accum=1, halves", halves_loss, 1)):
        t = trainer.Trainer(fn, tr.params, opt, trainer.TrainerConfig(
            total_steps=tz["accum_steps"], grad_accum=ga, log_every=100),
            device=dev)
        r = t.run(DeterministicIterator(make, seed=tz["seed"] + 1,
                                        device=dev), log=None)
        accum[name] = (r["losses"], {n: p.detach() for n, p in
                                     t.params.named_parameters()})
    (l2, p2), (l1, p1) = accum.values()
    loss_err = max(abs(a - b) for a, b in zip(l2, l1))
    steps_n = tz["accum_steps"]
    param_err = max(float((p2[n] - p1[n]).abs().max()) for n in p1)
    off_frac = max(float(((p2[n] - p1[n]).abs() > opt.lr * steps_n / 10)
                         .float().mean()) for n in p1)
    out["grad_accum"] = dict(steps=steps_n, losses_accum2=l2,
                             losses_accum1_halves=l1, max_loss_diff=loss_err,
                             max_param_diff=param_err,
                             frac_params_past_lr_steps_over_10=off_frac)
    log(f"  grad_accum: {json.dumps(out['grad_accum'])}")
    require(all(abs(a - b) <= 1e-4 + 1e-3 * abs(b) for a, b in zip(l2, l1)),
            f"grad_accum=2 losses {l2} against {l1}")
    require(param_err <= 2 * opt.lr * steps_n and off_frac <= 1e-2,
            f"grad_accum=2 params off by {param_err:.3e} ({off_frac:.4f} "
            "of the elements past lr * steps / 10)")
    del tr, model, accum, p1, p2
    return out


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
    t_start = time.perf_counter()
    if not rehearse and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    from repro_torch.configs.bimetric_paper import (cheap_tower,
                                                    cheap_tower_smoke,
                                                    expensive_tower)
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
        report["ptxas"] = _build.resources()
        for lib, kerns in report["ptxas"].items():
            for name, res in kerns.items():
                log(f"  {lib}: {name}: {res}")

    if rehearse:
        sizes = dict(n=3000, dims=(16, 48), ks=(8, 20), b=4,
                     timing={16: ((4, 8),), 48: ((4, 20),)},
                     local_timing={16: ((4, 8),), 48: ((4, 8),)},
                     shapes=((4, 16, 8),), cn=600, cd=8, cD=32, cq=4, quotas=(20, 60), bn=300, ctn=300,
                     fn=800, fq=8,
                     attn=(("sfr-mistral-7b layer, toy", 1, 2, 64, 16, BF16),
                           ("bge-micro-like layer, toy", 4, 2, 32, 16, F32)),
                     decode=(("decode, toy", 2, 2, 128, 16, BF16, False),
                             ("decode, toy, full cache", 1, 2, 128, 16, BF16,
                              True)),
                     bag_table=(4096, 18),
                     bag=(("din train_batch, toy", 256, 100),
                          ("din serve_p99, toy", 16, 100)),
                     towers=dict(cheap=cheap_tower_smoke,
                                 expensive=cheap_tower_smoke, cut_layers=1,
                                 docs=150, doc_len=24, queries=8,
                                 query_len=8, batch=64, quotas=(20, 40)),
                     serve=dict(queries=8, few=4, slots=4, quotas=(20, 40),
                                rerank_q=20, wait=120),
                     train=dict(tower=cheap_tower_smoke, batch=8, seq=16,
                                steps=10, warmup=3, seed=0, accum_steps=2,
                                temperature=0.2))
    else:
        # timing shapes: build wave (B=1024), stage-1 wave, stage-2 wave,
        # stage-2 entry wave (K = Q/2 seeds), re-rank scoring wave (K = Q)
        sizes = dict(n=args.n, dims=(384, 4096), ks=(64, 500, 1000), b=256,
                     timing={384: ((1024, 64), (256, 64)),
                             4096: ((256, 64), (256, 500), (256, 1000))},
                     local_timing={384: ((256, 64),), 4096: ((256, 64),)},
                     shapes=((1024, 256, 64), (256, 500, 64), (256, 1000, 64),
                             (256, 1000, 500)), cn=8192, cd=384, cD=4096, cq=16,
                     quotas=(100, 1000), bn=2048, ctn=2048, fn=args.n, fq=256,
                     # phase 6 at the configurations' widths: one attention
                     # layer (causal prefill) of each tower; decode at
                     # decode_32k's cache with batch 128 cut to 8 (one KV head
                     # per query head: 68.7 GB of KV at 128), lengths drawn
                     # in [1, S], and at batch 1 with the full cache (the
                     # fewest (b, h) rows); DIN's bag
                     attn=(("prefill, one sfr-mistral-7b layer", 1, 32, 4096,
                            128, BF16),
                           ("one bge-micro-like layer", 256, 6, 512, 64, F32)),
                     decode=(("sfr-mistral-7b at decode_32k, B 128 cut to 8",
                              8, 32, 32768, 128, BF16, False),
                             ("sfr-mistral-7b at decode_32k, B=1, full cache",
                              1, 32, 32768, 128, BF16, True)),
                     bag_table=(1 << 20, 18),
                     bag=(("din train_batch", 65536, 100),
                          ("din serve_p99", 512, 100)),
                     # phase 8: both towers full size, random weights;
                     # launch/serve.py's path at 2,048 docs of 256 tokens
                     # and 64 queries of 32, batch 64; the D tower's
                     # check on the CPU cut to its first 2 layers
                     towers=dict(cheap=cheap_tower,
                                 expensive=expensive_tower, cut_layers=2,
                                 docs=2048, doc_len=256, queries=64,
                                 query_len=32, batch=64, quotas=(50, 200)),
                     # phase 9: phase 8's towers, docs and queries through
                     # BiMetricEngine, 16 slots, Q alternating 50 and 200;
                     # (d)-(f) on the first 16 requests
                     serve=dict(queries=64, few=16, slots=16,
                                quotas=(50, 200), rerank_q=50, wait=600),
                     # phase 11: the d tower at full width, InfoNCE on
                     # contrastive_batch_fn(64, 256, 32768) (phase 8's doc
                     # length), 30 steps, AdamW lr 1e-3, warmup 20, at
                     # temperature 0.2 (at the default 0.05 a random d
                     # tower's loss is ~4e-6, at f32's resolution of logits
                     # near 20: it cannot be seen to fall)
                     train=dict(tower=cheap_tower, batch=64, seq=256,
                                steps=30, warmup=20, seed=0, accum_steps=4,
                                temperature=0.2))

    t0 = time.perf_counter()
    log("phase 2: kernels vs plain versions")
    g_err, g_rows, g_timed = check_gather(dev, sizes["n"], sizes["dims"],
                                          sizes["ks"], sizes["b"],
                                          sizes["timing"], rehearse)
    l_err, l_rows, l_timed = check_gather_local(
        dev, sizes["n"], sizes["dims"], sizes["ks"], sizes["b"],
        sizes["local_timing"], rehearse)
    m_err, m_rows, m_timed = check_merge(dev, sizes["shapes"], rehearse)
    for r in g_rows + l_rows + m_rows:
        log("  " + json.dumps(r))
    report.update(gather=g_rows, gather_local=l_rows, merge=m_rows,
                  phase2_s=time.perf_counter() - t0)
    log(f"  gather_score max |kernel - plain| {g_err:.3e}; gather_score_local "
        f"{l_err:.3e}, foreign lanes +0.0, shard sums == gather_score; "
        "merge exact")

    t0 = time.perf_counter()
    log("phase 3: the slice on the card vs on the CPU")
    report["cross"] = cross_check(dev, sizes["cn"], sizes["cd"], sizes["cD"],
                                  sizes["cq"], sizes["quotas"], sizes["bn"])
    report["phase3_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    log("phase 4: the full slice")
    full, ph4 = full_slice(dev, sizes["fn"], sizes["cd"], sizes["cD"],
                           sizes["fq"], sizes["quotas"], rehearse)
    report["full"] = full
    report["phase4_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    log("phase 5: the sharded slice (S shards on one device)")
    sharded = sharded_slice(dev, ph4, sizes["quotas"], rehearse)
    report["sharded"] = sharded
    report["phase5_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    log("phase 6: the kernels off the search path (ops entry points)")
    with torch.inference_mode():  # serving's mode: no autograd graph
        off_errs = check_off_path(dev, sizes["bag_table"][0])
        log(f"  checks vs plain: max |kernel - plain| {json.dumps(off_errs)}")
        off_rows, off_launches = off_path(dev, sizes, rehearse)
    report["off_path"] = dict(checks=off_errs, rows=off_rows,
                              launches=off_launches)
    report["phase6_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    log("phase 7: the cover-tree slice (on phase 4's data)")
    ct_cross = cover_tree_cross(dev, sizes["ctn"], sizes["cd"], sizes["cD"],
                                sizes["cq"])
    ct = cover_tree_slice(dev, ph4, full["runs"], sizes["quotas"], rehearse)
    report["covertree"] = dict(cross=ct_cross, full=ct)
    report["phase7_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    log("phase 8: the towers (embed_pool through EmbedTower, then search)")
    tw, ph8 = tower_slice(dev, sizes, rehearse)
    report["towers"] = tw
    report["phase8_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    log("phase 9: the serving engine (BiMetricEngine on phase 8's towers)")
    sv = serve_slice(dev, ph8, sizes, rehearse)
    del ph8
    report["serve"] = sv
    report["phase9_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    log("phase 10: scatter-gather search over per-shard sub-indices "
        "(core/distributed.py, on phase 4's data)")
    sg_cross = scatter_gather_cross(dev, sizes["cn"], sizes["cd"],
                                    sizes["cD"], sizes["cq"], sizes["quotas"])
    sg = scatter_gather_slice(dev, ph4, full["runs"], sizes["quotas"],
                              rehearse)
    del ph4
    sg["cross"] = sg_cross
    report["scatter_gather"] = sg
    report["phase10_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    log("phase 11: training the d tower (Trainer -> info_nce_loss -> "
        "flash_attention forward + backward kernels -> AdamW)")
    tn = train_slice(dev, sizes, rehearse)
    tn["bwd_rows"], bwd_err = check_attention_backward(dev, rehearse)
    report["train"] = tn
    report["phase11_s"] = time.perf_counter() - t0
    log(f"  phase 11 took {report['phase11_s']:.1f} s")

    kernels = [
        dict(name="gather_score", route="cuda",
             source="src/repro_torch/kernels/csrc/l2_topk.cu",
             replaces="src/repro/kernels/l2_topk.py:158",
             launches=full["launches"]["gather_score"],
             launches_covertree=ct["launches"]["gather_score"],
             launches_towers=tw["launches"]["gather_score"],
             launches_serve=sv["launches"]["gather_score"],
             launches_serve_sharded=sv["sharded"]["launches"]["gather_score"],
             launches_scatter_gather=sg["launches"]["gather_score"],
             max_abs_err=max(g_err, ct["wave_check"]["gather_max_abs_err"],
                             *(w["gather_max_abs_err"]
                               for w in tw["wave_checks"] + sv["wave_check"])),
             ms=g_timed.get("ms"), plain_ms=g_timed.get("plain_ms"),
             bound_ms=g_timed["bound_ms"], bound_by=g_timed["bound_by"],
             library_ms=None, device_ms=g_timed.get("device_ms")),
        dict(name="gather_score_local", route="cuda",
             source="src/repro_torch/kernels/csrc/l2_topk.cu",
             replaces="src/repro/kernels/l2_topk.py:256",
             launches=sharded["launches"]["gather_score_local"],
             launches_serve_sharded=sv["sharded"]["launches"][
                 "gather_score_local"],
             max_abs_err=max(l_err, *(w["gather_max_abs_err"] for w in
                                      sv["sharded"]["wave_check"])),
             ms=l_timed.get("ms"),
             plain_ms=l_timed.get("plain_ms"), bound_ms=l_timed["bound_ms"],
             bound_by=l_timed["bound_by"], library_ms=None,
             device_ms=l_timed.get("device_ms")),
        dict(name="beam_merge_topk", route="cuda",
             source="src/repro_torch/kernels/csrc/l2_topk.cu",
             replaces="src/repro/kernels/l2_topk.py:355",
             launches=full["launches"]["beam_merge_topk"],
             launches_covertree=ct["launches"]["beam_merge_topk"],
             launches_towers=tw["launches"]["beam_merge_topk"],
             launches_serve=sv["launches"]["beam_merge_topk"],
             launches_serve_sharded=sv["sharded"]["launches"][
                 "beam_merge_topk"],
             launches_scatter_gather=sg["launches"]["beam_merge_topk"],
             max_abs_err=m_err,
             ms=m_timed.get("ms"), plain_ms=m_timed.get("plain_ms"),
             bound_ms=m_timed["bound_ms"], bound_by=m_timed["bound_by"],
             library_ms=m_timed.get("library_ms"),
             # the device's time alone (graph replay); ms is eager, as for
             # every other kernel
             device_ms=m_timed.get("device_ms"),
             library_device_ms=m_timed.get("library_device_ms")),
    ]
    # the headline row of each off-path kernel: the first of its path's cases
    # (sfr-mistral-7b prefill, decode_32k, DIN train_batch sum)
    for name, src, replaces in (
            ("flash_attention", "flash_attention_wgmma",
             "flash_attention.py:76"),
            ("flash_decode", "flash_attention", "flash_attention.py:163"),
            ("embedding_bag", "embedding_bag", "embedding_bag.py:45")):
        row = next(r for r in off_rows if r["kernel"] == name)
        errs = [off_errs[name]] + [r["max_abs_err"] for r in off_rows
                                   if r["kernel"] == name]
        extra = {}
        if name == "flash_attention":  # phase 8: the towers' layers
            errs += [r["max_abs_err"] for r in tw["attention"]]
            extra["launches_towers"] = sum(
                n for k, n in tw["launches"].items()
                if k.startswith(name + "_")
                and not k.startswith("flash_attention_bwd"))
            extra["launches_serve"] = sum(
                n for k, n in sv["launches"].items()
                if k.startswith(name + "_")
                and not k.startswith("flash_attention_bwd"))
            extra["launches_train"] = sum(
                n for k, n in tn["launches"].items()
                if k in ("flash_attention_simt", "flash_attention_wgmma"))
        kernels.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{src}.cu",
            replaces=f"src/repro/kernels/{replaces}",
            launches=sum(n for k, n in off_launches.items()
                         if k == name or (k.startswith(name + "_") and not
                                          k.startswith("flash_attention_bwd"))),
            max_abs_err=max(errs), ms=row.get("ms"),
            plain_ms=row.get("plain_ms"), bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row.get("library_ms"),
            device_ms=row.get("device_ms"), **extra))
    # the backward: no TPU kernel; its row is d's training layer, the shape
    # of phase 11's path (the tf32 route in csrc/flash_attention_bwd.cu),
    # with D's layer (the wgmma route) beside it
    d_row, big_row = tn["bwd_rows"][:2]
    kernels.append(dict(
        name="flash_attention_bwd", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        source_wgmma="src/repro_torch/kernels/csrc/flash_attention_bwd_wgmma.cu",
        replaces="src/repro/models/layers.py:86",
        replaces_note="no TPU counterpart: JAX differentiates the jnp scan "
                      "of blockwise_attention with jax.grad",
        launches=tn["launches"]["flash_attention_bwd"], max_abs_err=bwd_err,
        launches_by_route={r: tn["launches"][f"flash_attention_bwd_{r}"]
                           for r in ("wgmma", "tf32", "simt")},
        route_d_layer=d_row["route"], ms=d_row.get("ms"),
        plain_ms=d_row.get("plain_ms"),
        bound_ms=d_row["bound_ms"], bound_by=d_row["bound_by"],
        bound_ms_f32=d_row["bound_ms_simt"],
        library_ms=d_row.get("library_ms"),
        device_ms=d_row.get("device_ms"),
        library_device_ms=d_row.get("library_device_ms"),
        simt_ms=d_row.get("simt_ms"), simt_no_lse_ms=d_row.get("simt_no_lse_ms"),
        launches_per_step=tn["launches"]["flash_attention_bwd"] // tn["steps"],
        route_D_layer=big_row["route"],
        ms_D_layer=big_row.get("ms"), plain_ms_D_layer=big_row.get("plain_ms"),
        bound_ms_D_layer=big_row["bound_ms"],
        bound_by_D_layer=big_row["bound_by"],
        library_ms_D_layer=big_row.get("library_ms"),
        device_ms_D_layer=big_row.get("device_ms"),
        library_device_ms_D_layer=big_row.get("library_device_ms"),
        simt_ms_D_layer=big_row.get("simt_ms")))
    report["kernels"] = kernels
    report["smoke_s"] = time.perf_counter() - t_start
    log(f"smoke finished in {report['smoke_s']:.1f} s (from start of main)")
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
