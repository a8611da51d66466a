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
   full, at batch 1; qwen3-0.6b's grouped cache, 16 query heads over 8 kv
   heads, at batch 8, also as MQA and in f32, lengths 1, S and one inside a
   split; DIN's bag), with
   times beside the bound, the plain version and the library call (SDPA
   with ``enable_gqa`` on a grouped cache); the
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
   a micro-batch's loss is its own); a second uninterrupted run bit-equal
   to the first, and a run checkpointed every 15 steps and killed at step
   20 before its final save, whose async checkpoint of step 15 a fresh
   ``Trainer`` resumes (the step and the data cursor) to 30, its losses 16-30
   and its params, master copy and moments bit-equal, with the save's
   time beside the step's; after the path, the backward kernel
   against its plain version at d's and D's layer shapes and the edges
   (non-causal Sq < Skv, Sq > Skv with empty rows, dv != dh, f16, 32-row
   tiles, each route's tile edges, heads left to the SIMT kernel), each on
   the route ``_backward_route`` picks, given the forward's log-sum-exp;
   the two layers timed (eager, graph replay, the profiler's split) beside
   the bound of the route's operations, the SIMT kernel on the same
   inputs, the plain version and SDPA's backward timed alone;
12. the LM path, ``qwen3_0_6b.full()`` at full width from a seed: (a)
   ``prefill`` of 8 prompts of 32,704 tokens into a 32,768 cache and 64
   greedy ``decode_step``s that fill it (``flash_decode`` on the grouped
   cache, 28 launches a step), the first and last step's logits against
   the forward's on the same tokens, one step under
   ``set_sync_debug_mode("error")``, prefill s, ms a step beside its byte
   bound, tokens/s, peak memory and a traced step; (b) a copy cut to 2
   layers decoded on the card and on the CPU; (c) ``launch/train.py``'s
   path, ``loss_fn`` under the ``Trainer`` at batch 2 and seq 4,096 (two
   chunks of the cross entropy; the backward on the wgmma route), 12
   steps, then again with checkpoints, killed after the launcher's async
   one at step 10 and before its final save, and resumed from it through
   the launcher, bit-equal;
13. ``launch/train_biencoder.main`` at ``--scale 100m``, 10 steps, then 20
   on the same checkpoint directory (it must resume from step 10), its
   search launching the gather and the merge; recall@10 under the teacher;
14. the recommender models (``models/recsys.py``) at their full configs,
   weights from each ``*_init`` with a seeded generator on the card: per
   model (a) serving at 512 and 262,144 rows (BERT4Rec's ``_serve`` top-10;
   xDeepFM in row chunks of 32,768), ms, rows/s, peak memory and a traced
   bulk batch; (b) one user against 10^6 candidates (DIN over candidate
   chunks of 131,072, xDeepFM's own scan at 40,000), a 4,096-candidate
   slice against the forward on the tiled inputs; (c) 10 ``Trainer``
   steps (AdamW, no weight decay) at the training batch (BERT4Rec 8,192 in
   loss chunks of 512, xDeepFM 16,384) on synthetic batches whose labels
   follow a rule of the ids, the losses finite and falling, every table's
   gradient nonzero, the step's split, the backward's launches by route
   (``simt`` for BST's heads of 4, ``tf32`` for BERT4Rec's of 32, both
   required); then (d) each model on the card against a CPU copy with its
   tables cut to 65,536 rows (logits, loss, every gradient on 64 rows) and
   (e) the attention kernels at BST's (512, 8, 21, 4) and BERT4Rec's (64,
   2, 200, 32) against their plain versions, bit-equal twice, timed beside
   their bounds and SDPA;
15. MoE, MLA and the MTP head: (a) ``granite_moe_3b_a800m.full()`` (32
   layers, 40 experts top-8) and (b) ``deepseek_v3_671b.full()`` at its
   full widths cut to 4 layers (3 dense, one MoE of 256 experts and a
   shared one, the MTP head), bf16 from a seed on the card: ``prefill`` of
   8 prompts (2,048 / 1,024 tokens) into a 4,096 cache, then 64 / 32 greedy
   ``decode_step``s, every step under ``set_sync_debug_mode("error")``;
   launches counted from 0 over the prefill (``flash_attention_wgmma``, one
   a layer; MLA at qk 192 / v 128) and over the steps (granite:
   ``flash_decode`` on its 24-over-8 cache, one a layer a step; DS-V3's
   absorbed MLA decode is plain products); prefill tokens/s, ms a step
   beside its byte bound (all experts' weights: every expert product runs),
   decode tokens/s, peak memory, the share of assignments dropped at
   prefill, a second prefill bit-equal; (c) against CPU copies at full
   widths: granite cut to 2 layers in f32 (logits, aux, z; then decode =
   forward at ``capacity_factor=16`` on the card), DS-V3's first layer in
   bf16 (attention, cache entries, the layer, the absorbed decode against
   the forward) and its MoE cut to 16 experts at T=31 and 64 (routing
   equal exactly); (d) ``loss_fn`` and its gradients of both smoke configs
   card = CPU, and ``launch/train.py --preset smoke`` for both on the card;
   (e) ``flash_attention`` at DS-V3's MLA prefill layer and granite's, and
   ``flash_decode`` at granite's cache, against their plain versions, timed
   beside their bounds and SDPA (with the backend SDPA picks);
16. the GAT graph model (``models/gnn.py``, ``configs/gat_cora.py``) at
   gat-cora's widths (2 layers, 8 heads, d_hidden 8), f32, weights from
   ``init_params`` on the card: (a) the forward at each of the four
   ``GNN_SHAPES`` at full size (Cora's graph padded; a ``sample_block`` of
   1,024 seeds at fanouts (15, 10) from a Reddit-size CSR graph; ogb_products'
   2.45 M nodes and 61.9 M edges, its messages summed in chunks; 128
   molecules), with the warm time, nodes/s and edges/s, peak memory beside
   the bytes reckoned from the shapes, a second call bit-equal and a third
   under ``set_sync_debug_mode("error")``; (b) card against CPU (logits,
   loss, every gradient) at full_graph_sm, molecule and minibatch_lg, and
   ogb_products' model on a 131,072-node graph at its mean degree, summed
   in chunks smaller than E on both devices (there also autograd's saved
   backward, the edges in one chunk, against the chunked one, which
   recomputes the softmax and each chunk: within 4x the f32 noise); (c) 10 ``Trainer`` steps
   (AdamW, no weight decay) at full_graph_sm and molecule on a fixed batch
   (losses falling) and at minibatch_lg on a fresh block each step, labels
   a rule of each node's in-neighbours' features, with the step's split,
   the sampler's host time and peak memory, and (e) at ogb_products 5
   full-batch AdamW steps of ``gat_cora.build_gnn_cell(None,
   "ogb_products").fn`` on (a)'s batch: step 0's loss bit-equal to the
   forward's, the losses falling, the step's split, peak memory beside
   the bytes reckoned from the shapes; (d)
   ``launch/gnn_corpus_search.main`` at ogbn-arxiv's size (169,343 nodes,
   mean degree 7, 128 features, 64 queries, Q in {64, 256}), the search
   kernels' launches counted from 0, each query within Q D calls, then one
   wave of each metric held against the plain versions;
17. the dense LMs of the registry, ``granite-20b`` (52 layers, 48 query
   heads over 1 kv head) and ``deepseek-coder-33b`` (62 layers, 56 over 8),
   one at a time, drawn in bf16 on the card at full depth (the phase
   fails if the weights and caches do not fit) and driven through their cells'
   ``fn`` (``configs.get_arch(name).build_cell``): (a) the prefill cell on
   8 (granite) or 4 prompts of 4,096 tokens into caches of 4,160, twice,
   bit-equal, then 64 decode steps through the decode cell, every step
   under ``set_sync_debug_mode("error")``, launches counted from 0 over
   each; the first and last step's logits against the forward's (cosine >=
   0.99 a row); prefill tokens/s, ms a step beside its byte bound, peak
   memory; ``embed_pool`` of 64 documents of 256 tokens; (b) the
   decode_32k cell's cache with the batch cut to 8 (granite) or 1, random
   k and v at length 32,767, 8 steps timed beside their byte bound, a
   traced step; (c) each cut to 2 layers in f32 on the card and the CPU:
   forward, prefill and decode card against CPU, decode against the
   forward, within 1e-4 of max |logit|; (d) ``flash_attention`` at both
   prefill layers and ``flash_decode`` at both decode_32k caches against
   their plain versions, timed beside their bounds and SDPA;
18. training on a mesh: (a) qwen3-0.6b's train_4k cell (28 layers, full
   width, bf16, the batch 256 cut to 2, one row a data shard) on
   ``make_mesh((2, 2), ("data", "model"), devices=["cuda:0"] * 4)``, its
   weights drawn on the card from a seed and placed by
   ``abstract_args(mesh)``'s shardings: every block of its spec's shape,
   the blocks' bytes (each element once) the unsharded state's, step 0's
   loss, weights and master copy within 4x the f32 noise of the unsharded
   step on a copy (the noise: that step with the two rows in the other
   order; the moments' gaps are printed: they read the gradient, which
   each row rounds to bf16 on its own), the master copy and moments
   bit-equal to AdamW on the two rows' gradients summed in row order,
   three steps with the wgmma forward and backward launches
   exactly twice the unsharded step's (a set a data shard), ms a step
   beside the unsharded step, the bytes at each position and the peak; (b)
   GPipe over the same 28 blocks as 4 stages of 7 on ``["cuda:0"] * 4``,
   4 microbatches of 1 x 4,096 embedded tokens, ``remat=True``: outputs
   bit-equal to the blocks run on each microbatch in turn, the gradients
   of the mean square within 4x the noise of that loop with the
   microbatches in another order, launches exact, both timed; (c)
   ``quantized_psum`` over (a)'s two data shards' step-0 gradients (every
   leaf): each element within S · scale / 2 of the exact sum (plus the
   bf16 rounding of the output), the card's bit-equal to the CPU's on the
   embedding and the first block's leaves, the relative error as JAX's
   test reads it.

Phases 6, 8, 9, 12's decoding, 14's serving and 15's run under
``torch.inference_mode()``
(serving records no autograd graph); ``flash_decode`` and
``embedding_bag`` have no backward and refuse an input that requires
grad.

Ends with a JSON line of every ported kernel and the result line
``{"ok": true, "device": {...}}``. Needs one CUDA device; imports no JAX.
``--rehearse`` runs the control flow on the CPU at toy sizes and exits 3.
"""
from __future__ import annotations

import argparse
import contextlib
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
# grouped caches (B, H, Hkv, S, dh, dv, dtype, lengths): GQA and MQA, on the
# vector path (qwen3-0.6b's 16 over 8 heads of 128; rows of 24/40) and the
# scalar one (18/30), each at a length per row that includes 1 and S
DECODE_GQA_CHECKS = [
    (3, 16, 8, 1000, 128, 128, BF16, (1, 517, 1000)),
    (2, 8, 1, 333, 64, 64, F32, (333, 1)),
    (3, 6, 2, 200, 24, 40, F16, (1, 77, 200)),
    (2, 4, 2, 100, 18, 30, F32, (100, 1)),
    (2, 12, 3, 300, 128, 128, F16, None),
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


def _decode_inputs(g, dev, b, h, s, dh, dv, dtype, hkv=None):
    """q (B, H, dh) and a cache of ``hkv`` (default H) kv heads."""
    hkv = h if hkv is None else hkv
    return (torch.randn(b, h, dh, generator=g, device=dev, dtype=dtype),
            torch.randn(b, s, hkv, dh, generator=g, device=dev, dtype=dtype),
            torch.randn(b, s, hkv, dv, generator=g, device=dev, dtype=dtype))


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
    for b, h, hkv, s, dh, dv, dt, lens in (
            [(b, h, h, s, dh, dv, dt, lens)
             for b, h, s, dh, dv, dt, lens in DECODE_CHECKS]
            + DECODE_GQA_CHECKS):
        q, k, v = _decode_inputs(g, dev, b, h, s, dh, dv, dt, hkv)
        length = (torch.randint(1, s + 1, (b,), generator=g, device=dev)
                  if lens is None else torch.tensor(lens, device=dev))
        before = fa.launches["flash_decode"]
        got = ops.flash_decode(q, k, v, length=length)
        want = fa.flash_decode_plain(q, k, v, length=length)
        what = f"flash_decode {(b, h, hkv, s, dh, dv, dt, lens)}"
        require(dev.type != "cuda" or fa.launches["flash_decode"] == before + 1,
                f"{what}: not one launch per call")
        errs["flash_decode"] = max(errs["flash_decode"], _agree(
            got, want, ATTN_TOL[dt], what))
        if lens is not None and lens[0] == 0:
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
    # the grouped rows draw from a generator of their own, so that every
    # other row's inputs are the ones before grouped caches
    g_gqa = torch.Generator(device=dev).manual_seed(18)
    for role, b, h, hkv, s, d, dt, lengths in sizes["decode"]:
        gen = g if hkv == h else g_gqa
        q, k, v = _decode_inputs(gen, dev, b, h, s, d, d, dt, hkv)
        # "full": every key; a tuple: those lengths, then seeded in [1, S]
        length = (torch.full((b,), s, device=dev, dtype=torch.int32)
                  if lengths == "full" else
                  torch.randint(1, s + 1, (b,), generator=gen, device=dev,
                                dtype=torch.int32))
        if isinstance(lengths, tuple):
            length[:len(lengths)] = torch.tensor(lengths, device=dev)
        valid = int(length.sum())
        item = q.element_size()
        mask = (torch.arange(s, device=dev)[None, :] < length[:, None])[
            :, None, None]
        # the yardstick's layout, (B, Hkv, S, d), made outside its timing
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)
        gqa = {"enable_gqa": True} if hkv != h else {}
        cases.append(dict(
            kernel="flash_decode", role=role, shape=dict(
                B=b, H=h, Hkv=hkv, S=s, dh=d, dv=d, dtype=str(dt),
                valid_keys=valid, lengths=length.tolist() if b <= 8 else None,
                chunk=fa.decode_split(s, b * h)[0]),
            # the valid cache read once (each kv head once), q and out
            bound=bound(item * (valid * hkv * 2 * d + 2 * b * h * d) + 4 * b,
                        2 * 2 * d * h * valid, _ops_rate(dt)),
            run=lambda q=q, k=k, v=v, n=length: ops.flash_decode(
                q, k, v, length=n),
            plain=lambda q=q, k=k, v=v, n=length: fa.flash_decode_plain(
                q, k, v, length=n),
            library=lambda q=q, kt=kt, vt=vt, mask=mask, gqa=gqa:
                F.scaled_dot_product_attention(
                    q[:, :, None], kt, vt, attn_mask=mask, **gqa)[:, :, 0],
            library_name="F.scaled_dot_product_attention, (B, 1, 1, S) bool "
                         "mask" + (", enable_gqa=True" if gqa else ""),
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


def _cut_copy(model, n_layers, device, **changes):
    """A copy on ``device`` of ``model``'s first ``n_layers`` layers, its
    token table, final norm and heads, with its config's other ``changes``
    (``dtype``: the weights converted)."""
    import dataclasses

    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(model.cfg, n_layers=n_layers, **changes)
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
        kind = ("attention" if "flash_" in name else "products"
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
    del accum, p1, p2

    # a second uninterrupted run, then a run killed after its async
    # checkpoint and resumed by a fresh Trainer: both bit-equal to the first
    def make_trainer(ckpt_dir):
        return trainer.Trainer(loss_fn, model, opt, trainer.TrainerConfig(
            total_steps=tz["steps"], ckpt_dir=ckpt_dir,
            ckpt_every=tz["steps"] // 2, log_every=100), device=dev)

    def make_iter(state=None):
        if state is None:
            return DeterministicIterator(make, seed=tz["seed"], device=dev)
        return DeterministicIterator.from_state(make, state, device=dev)

    stop = tz["steps"] // 2
    out["resume"] = check_resume(make_trainer, make_iter, tr, losses, stop,
                                 stop + max(1, stop // 3), "phase 11")
    out["resume"]["step_ms"] = out["step_ms_median_last20"]
    log(f"  resume: {json.dumps(out['resume'])}")
    del tr, model
    return out


def same_state(a, b, what):
    """Two trainers' params, optimizer state (step, f32 master, moments) and
    error feedback, bit for bit."""
    from repro_torch.checkpoint.manager import flatten

    sa, sb = flatten(a._tree()), flatten(b._tree())
    require(sa.keys() == sb.keys(), f"{what}: the states' leaves differ")
    diff = [p for p in sa if not torch.equal(sa[p], sb[p])]
    require(not diff, f"{what}: {len(diff)} of {len(sa)} tensors differ, "
            f"first {diff[:4]}")
    return len(sa)


def drop_final_save(manager, stop, past, what):
    """Leave on disk what a job killed between its async checkpoint at
    ``stop`` and step ``past`` leaves: the final synchronous save at
    ``past``, which that job would not have written, is removed, so a
    resume reads the checkpoint that the worker thread wrote while the
    next steps updated the tensors in place."""
    import shutil

    steps = manager.all_steps()
    require(steps == [stop, past],
            f"{what}: checkpoints at {steps}, not [{stop}, {past}]")
    shutil.rmtree(Path(manager.directory) / f"step_{past:08d}")


def check_resume(make_trainer, make_iter, ref, ref_losses, stop, past, what):
    """Against ``ref``, a Trainer run uninterrupted to the end, from
    ``make_trainer(None)``'s start: (1) a second uninterrupted run, bit for
    bit; (2) a run with a checkpoint directory (``ckpt_every=stop``) taken
    on to ``past``, killed there as if before its final save, and a fresh
    Trainer that restores the async checkpoint at ``stop`` and the data
    cursor and runs to the end: its losses after ``stop``, its params,
    master copy and moments bit-equal. Returns the save's and the
    restore's seconds."""
    import tempfile

    again = make_trainer(None)
    r = again.run(make_iter(), log=None)
    require(r["losses"] == ref_losses,
            f"{what}: two uninterrupted runs' losses differ")
    n = same_state(again, ref, f"{what}: two uninterrupted runs")
    del again
    out = dict(stop=stop, past=past, tensors=n)
    with tempfile.TemporaryDirectory() as d:
        first = make_trainer(d)
        it = make_iter()
        first.run(it, steps=past, data_state_fn=it.state, log=None)
        out.update({f"save_{k}": v for k, v in first.manager.timings.items()})
        drop_final_save(first.manager, stop, past, what)
        del first, it
        fresh = make_trainer(d)
        t0 = time.perf_counter()
        state = fresh.maybe_restore(make_iter().state())
        out["restore_s"] = time.perf_counter() - t0
        require(fresh.step == stop, f"{what}: restored step {fresh.step}")
        r = fresh.run(make_iter(state), log=None)
        require(r["losses"] == ref_losses[stop:],
                f"{what}: the resumed losses {r['losses']} differ from "
                f"{ref_losses[stop:]}")
        same_state(fresh, ref, f"{what}: the resumed run")
        del fresh
    return out


# --------------------------------------------------------------------------
# phase 12: the LM path (qwen3-0.6b): prefill and decode, and training
# --------------------------------------------------------------------------
# decode logits against the forward's on the same tokens: a cosine per row
# and max |diff| over max |logit| (the towers' bf16 limits); fixed before
# the first run
LM_COS, LM_REL = 0.999, 2e-2


def _logits_gap(got, want):
    """(B, V) logits against ``want``'s: the least cosine of a row, max
    |diff| over max |logit| (``rel``), the root-mean-square ratio, and where
    the max |diff| falls."""
    import torch.nn.functional as F

    g, w = got.float().cpu(), want.float().cpu()
    diff = (g - w).abs()
    at = divmod(int(diff.argmax()), g.shape[-1])
    res = dict(min_cos=float(F.cosine_similarity(g, w, dim=-1).min()),
               max_abs=float(diff.max()),
               max_abs_logit=float(w.abs().max()),
               # the spread of the whole difference, beside its extreme
               rms_rel=float(diff.square().mean().sqrt()
                             / w.square().mean().sqrt()),
               max_at=dict(row=at[0], token=at[1], want=float(w[at]),
                           got=float(g[at])))
    res["rel"] = res["max_abs"] / res["max_abs_logit"]
    return res


def _logits_agree(got, want, what):
    require(got.shape == want.shape and bool(torch.isfinite(got).all()),
            f"{what}: shape {tuple(got.shape)} or non-finite logits")
    res = _logits_gap(got, want)
    require(res["min_cos"] >= LM_COS and res["rel"] <= LM_REL,
            f"{what}: {res}")
    return res


def lm_decode(dev, model, lz, rehearse):
    """(a) ``prefill`` of B prompts into a cache of ``max_seq``, then greedy
    ``decode_step``s that fill it exactly; launches counted over the
    steps; the first and last step's logits against the forward's on the
    same tokens; one step under ``set_sync_debug_mode("error")``."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer as T

    cfg = model.cfg
    b, p, s = lz["batch"], lz["prompt"], lz["max_seq"]
    n = s - p
    rng = np.random.default_rng(lz["seed"])
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (b, p))).to(dev)
    out = dict(config=cfg.name, batch=b, prompt=p, max_seq=s, steps=n)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    with torch.inference_mode():
        fa.reset_launches()
        sync()
        t0 = time.perf_counter()
        logits, cache = T.prefill(model, prompts, max_seq=s)
        sync()
        out["prefill_s"] = time.perf_counter() - t0
        out["prefill_launches"] = dict(fa.launches)
        require(tuple(logits.shape) == (b, 1, cfg.vocab),
                f"prefill logits {tuple(logits.shape)}")
        toks = [logits[:, -1].argmax(-1, keepdim=True)]
        fa.reset_launches()  # the decode path starts here
        sync()
        t0 = time.perf_counter()
        for i in range(n):
            guard = i == 1 and dev.type == "cuda"
            if guard:  # a step that reads nothing back to the host
                torch.cuda.set_sync_debug_mode("error")
            try:
                lg, cache = T.decode_step(model, toks[-1], cache)
            finally:
                if guard:
                    torch.cuda.set_sync_debug_mode(0)
            if i == 0:
                first = lg
            toks.append(lg[:, -1].argmax(-1, keepdim=True))
        sync()
        out["decode_s"] = time.perf_counter() - t0
        launches = dict(fa.launches)  # read just after the path
        out["launches"] = launches
        require(int(cache.length) == s, f"cache length {int(cache.length)}")
        require(rehearse or launches["flash_decode"] == cfg.n_layers * n,
                f"flash_decode launched {launches['flash_decode']} times, "
                f"not {cfg.n_layers} x {n}")
        out["ms_per_step"] = 1e3 * out["decode_s"] / n
        out["tokens_per_s"] = b * n / out["decode_s"]
        # a step's least bytes: every weight once, the cache's valid part
        # (its mean length over the steps) once, the new k and v written
        item = torch.finfo(cfg.dtype).bits // 8
        weights = sum(t.numel() * t.element_size() for t in model.parameters())
        kv_row = cfg.n_layers * b * cfg.n_kv_heads * 2 * cfg.head_dim * item
        step_bytes = weights + kv_row * (p + (n + 1) / 2 + 1)
        out["step_bound_ms"] = 1e3 * step_bytes / HBM_BYTES_PER_S
        out["step_bytes"] = step_bytes
        # the references: the forward on the same tokens
        seq = torch.cat([prompts] + toks[:-1], dim=1)
        for name, lgt, upto in (("first", first, p + 1), ("last", lg, s)):
            hid = T.forward(model, seq[:, :upto], with_logits=False).hidden
            out[f"{name}_step_vs_forward"] = _logits_agree(
                lgt[:, 0], hid[:, -1] @ model.embed.T,
                f"decode step {name} vs forward")
            del hid
        out["tokens_head"] = seq[0, p:p + 8].tolist()
        if not rehearse:  # one more step traced (the full cache's last slot)
            out["profile_step"] = profile_batch(
                lambda: T.decode_step(model, toks[-1], cache))
    del cache
    log(f"  (a) prefill {b} x {p} tokens in {out['prefill_s']:.3f} s; {n} "
        f"decode steps {out['ms_per_step']:.3f} ms a step (byte bound "
        f"{out['step_bound_ms']:.3f} ms), {out['tokens_per_s']:.1f} tokens/s; "
        f"launches {launches}")
    log(f"      first step vs forward {out['first_step_vs_forward']}; last "
        f"{out['last_step_vs_forward']}; traced step "
        f"{json.dumps(out.get('profile_step'))}")
    return out


def lm_cross(dev, model, lz):
    """(b) a copy cut to the first layers, prefilled and decoded on the card
    and on the CPU on the same tokens (the card's greedy choices)."""
    from repro_torch.models import transformer as T

    cz = lz["cross"]
    card = _cut_copy(model, lz["cut_layers"], dev)
    host = _cut_copy(model, lz["cut_layers"], "cpu")
    rng = np.random.default_rng(lz["seed"] + 1)
    prompts = torch.from_numpy(rng.integers(0, model.cfg.vocab,
                                            (cz["batch"], cz["prompt"])))
    s = cz["prompt"] + cz["steps"]
    worst = dict(min_cos=1.0, rel=0.0)
    with torch.inference_mode():
        lc, cc = T.prefill(card, prompts.to(dev), max_seq=s)
        lh, ch = T.prefill(host, prompts, max_seq=s)
        for i in range(cz["steps"] + 1):
            r = _logits_agree(lc[:, 0], lh[:, 0], f"cut copy, step {i}")
            worst = dict(min_cos=min(worst["min_cos"], r["min_cos"]),
                         rel=max(worst["rel"], r["rel"]))
            if i == cz["steps"]:
                break
            tok = lc[:, -1].argmax(-1, keepdim=True)
            lc, cc = T.decode_step(card, tok, cc)
            lh, ch = T.decode_step(host, tok.cpu(), ch)
    out = dict(layers=lz["cut_layers"], batch=cz["batch"],
               prompt=cz["prompt"], steps=cz["steps"], **worst)
    log(f"  (b) {lz['cut_layers']} layers, card vs CPU: {out}")
    return out


def lm_train(dev, lz, rehearse):
    """(c) ``launch/train.py``'s path: ``loss_fn`` under the ``Trainer`` at
    full width, launches counted by route over an uninterrupted run; the
    forward / backward / optimizer split; then the run again with a
    checkpoint directory, killed after its async checkpoint (the
    launcher's every ``max(steps // 3, 10)`` steps) and resumed from it
    through the launcher, bit-equal."""
    import tempfile

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train as launch_train
    from repro_torch.models import transformer as T

    tz = lz["train"]
    args = ["--arch", tz["arch"], "--preset", tz["preset"], "--batch",
            str(tz["batch"]), "--seq", str(tz["seq"]), "--device",
            dev.type]
    steps = ["--steps", str(tz["steps"])]
    out = dict(arch=tz["arch"], preset=tz["preset"], batch=tz["batch"],
               seq=tz["seq"], steps=tz["steps"])
    if dev.type == "cuda":
        out["memory_allocated_at_start"] = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()  # the path starts here
    t0 = time.perf_counter()
    ref, res = launch_train.main(args + steps)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = dict(fa.launches)  # read just after the path
    out["run_s"] = time.perf_counter() - t0
    losses = res["losses"]
    tail = ref.step_times[-(tz["steps"] - 2):]
    out.update(losses=losses, launches=launches,
               step_ms=[1e3 * t for t in ref.step_times],
               step_ms_median=1e3 * statistics.median(tail),
               tokens_per_s=tz["batch"] * tz["seq"] / statistics.median(tail),
               ce_chunks=-(-tz["seq"] // ref.params.cfg.ce_chunk))
    if dev.type == "cuda":
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    require(all(math.isfinite(x) for x in losses), "an LM loss is not finite")
    n_layers = ref.params.cfg.n_layers
    if not rehearse:
        require(launches["flash_attention_bwd_wgmma"] > 0
                and launches["flash_attention_bwd_wgmma"]
                == launches["flash_attention_bwd"],
                f"the LM's backward did not run on the wgmma route: "
                f"{launches}")
        require(launches["flash_attention_bwd"] == n_layers * tz["steps"],
                f"backward launches {launches['flash_attention_bwd']}")
    # the split at the trained weights, on one more batch
    from repro_torch.data.pipeline import lm_batch_fn

    batch = {k: torch.as_tensor(x).to(dev) for k, x in lm_batch_fn(
        tz["batch"], tz["seq"], ref.params.cfg.vocab)(99, 0).items()}
    params = list(ref.params.parameters())
    out["forward_ms"] = 1e3 * _wall_s(
        lambda: T.loss_fn(ref.params, batch)[0], 3)
    out["forward_backward_ms"] = 1e3 * _wall_s(
        lambda: torch.autograd.grad(T.loss_fn(ref.params, batch)[0], params,
                                    allow_unused=True), 3)
    out["backward_ms"] = out["forward_backward_ms"] - out["forward_ms"]
    out["optimizer_and_rest_ms"] = (out["step_ms_median"]
                                    - out["forward_backward_ms"])
    del batch, params
    log(f"  (c) loss curve {json.dumps([round(x, 5) for x in losses])}")
    log(f"      step {out['step_ms_median']:.3f} ms (median of the last "
        f"{len(tail)}), {out['tokens_per_s']:.0f} tokens/s; forward "
        f"{out['forward_ms']:.3f} ms, backward {out['backward_ms']:.3f} ms, "
        f"optimizer and the rest {out['optimizer_and_rest_ms']:.3f} ms; "
        f"launches {launches}; max_memory_allocated "
        f"{out.get('max_memory_allocated')} bytes")
    # again with checkpoints, killed after the async one, then resumed by
    # the launcher
    with tempfile.TemporaryDirectory() as d:
        first, r = launch_train.main(args + steps + ["--ckpt-dir", d])
        require(r["losses"] == losses,
                "the LM's losses differ between two uninterrupted runs")
        stop = out["stop"] = first.cfg.ckpt_every
        require(stop < tz["steps"], f"no async checkpoint before step "
                f"{tz['steps']} (every {stop})")
        out.update({f"save_{k}": v for k, v in first.manager.timings.items()})
        drop_final_save(first.manager, stop, tz["steps"], "phase 12(c)")
        del first
        t0 = time.perf_counter()
        again, r = launch_train.main(args + steps + ["--ckpt-dir", d])
        out["resumed_run_s"] = time.perf_counter() - t0
        require(again.step == tz["steps"] and r["losses"] == losses[stop:],
                f"the resumed LM losses {r['losses']} differ from "
                f"{losses[stop:]}")
        out["resume_tensors"] = same_state(again, ref, "phase 12(c) resume")
        del again
    log(f"      resumed from step {stop}: losses and "
        f"{out['resume_tensors']} state tensors bit-equal; a save "
        f"{out['save_host_copy_s']:.3f} s to the host + "
        f"{out['save_write_s']:.3f} s of writing, beside a "
        f"{out['step_ms_median']:.3f} ms step")
    del ref
    return out


def lm_slice(dev, sizes, rehearse):
    """Phase 12: the LM path at ``sizes["lm"]``."""
    from repro_torch.models import transformer as T

    lz = sizes["lm"]
    cfg = lz["cfg"]()
    out = dict(config=cfg.name)
    if dev.type == "cuda":
        out["memory_allocated_at_start"] = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    model = T.init_params(lz["seed"], cfg, device=dev)
    out["decode"] = lm_decode(dev, model, lz, rehearse)
    if dev.type == "cuda":
        out["decode"]["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        log(f"      peak memory {out['decode']['max_memory_allocated']} bytes")
    out["cross"] = lm_cross(dev, model, lz)
    del model
    out["train"] = lm_train(dev, lz, rehearse)
    return out


# --------------------------------------------------------------------------
# phase 13: the end-to-end bi-encoder example
# --------------------------------------------------------------------------
def biencoder_slice(dev, sizes, rehearse):
    """Phase 13: ``launch/train_biencoder.main`` at ``--scale``, run to
    ``stop`` steps and then to ``steps`` on one checkpoint directory: the
    second run must resume from ``stop``; its search launches the gather
    and the merge."""
    import tempfile

    from repro_torch.kernels import l2_topk
    from repro_torch.launch import train_biencoder

    bz = sizes["biencoder"]
    out = dict(scale=bz["scale"], stop=bz["stop"], steps=bz["steps"])
    with tempfile.TemporaryDirectory() as d:
        args = ["--scale", bz["scale"], "--ckpt-dir", d, "--device", dev.type]
        t0 = time.perf_counter()
        first = train_biencoder.main(args + ["--steps", str(bz["stop"])])
        out["first_s"] = time.perf_counter() - t0
        require(first["resumed_from"] == 0, "the first run resumed")
        l2_topk.reset_launches()  # the path starts here
        t0 = time.perf_counter()
        second = train_biencoder.main(args + ["--steps", str(bz["steps"])])
        if dev.type == "cuda":
            torch.cuda.synchronize()
        out["launches"] = dict(l2_topk.launches)  # read just after the path
        out["second_s"] = time.perf_counter() - t0
    require(second["resumed_from"] == bz["stop"],
            f"resumed from step {second['resumed_from']}, not {bz['stop']}")
    losses = first["losses"] + second["losses"]
    require(all(math.isfinite(x) for x in losses), "a loss is not finite")
    require(max(second["D_calls"]) <= train_biencoder.QUOTA,
            f"D calls {max(second['D_calls'])} past the quota")
    require(0.0 <= second["recall_at_10"] <= 1.0, "recall@10")
    if not rehearse:
        for name in ("gather_score", "beam_merge_topk"):
            require(out["launches"][name] > 0,
                    f"{name} was never launched on phase 13's path")
    out.update(losses=losses, resumed_from=second["resumed_from"],
               recall_at_10=second["recall_at_10"],
               max_D_calls=max(second["D_calls"]))
    log(f"  resumed from step {second['resumed_from']}; recall@10 "
        f"{second['recall_at_10']:.4f} at Q={train_biencoder.QUOTA}; "
        f"launches {out['launches']}; runs {out['first_s']:.1f} s + "
        f"{out['second_s']:.1f} s")
    return out


# --------------------------------------------------------------------------
# phase 14: the recommender models
# --------------------------------------------------------------------------
RECSYS_MODELS = ("bst", "din", "bert4rec", "xdeepfm")
# card against CPU (d): logits and loss within 1e-4 x their max |value|;
# each gradient within 1e-4 x its leaf's max |gradient|, plus 1e-8 x the
# largest |gradient| of any leaf (DIN's last attention bias, which its
# softmax does not see: 0 in exact arithmetic, rounding noise on both
# sides); fixed before the first run
RECSYS_CROSS_REL = 1e-4
RECSYS_GRAD_FLOOR = 1e-8
# retrieval against the forward on the tiled inputs (JAX's check)
RECSYS_SCORE_REL = 1e-5
# the tables of each model, whose gradients must not be all zero
RECSYS_TABLES = {"bst": ("item_emb",), "din": ("item_emb",),
                 "bert4rec": ("item_emb",), "xdeepfm": ("table", "linear")}


def _rs_batch(name, cfg, b, g, dev, pool):
    """A seeded batch of ``name``'s loss on the card, ids from the first
    ``pool`` rows (each row seen often enough that a step can learn it);
    labels by a fixed rule of the ids: BST and DIN 1 where the target id is
    a multiple of 4 (a quarter of the rows: the base rate alone lets a loss
    fall in a few steps; 10 % of history ids padding, -1); xDeepFM the same
    rule on the first candidate field's id; BERT4Rec's masked labels the
    items at the masked positions (the input is not masked, as in JAX's
    loss)."""
    def ids(hi, *shape):
        return torch.randint(0, hi, shape, generator=g, device=dev,
                             dtype=torch.int32)

    if name in ("bst", "din"):
        hist = ids(pool, b, cfg.seq_len)
        pad = torch.rand(hist.shape, generator=g, device=dev) < 0.1
        target = ids(pool, b)
        return {"hist": torch.where(pad, -1, hist), "target": target,
                "label": (target % 4 == 0).float()}
    if name == "bert4rec":
        items = ids(pool, b, cfg.seq_len)
        pos = ids(cfg.seq_len, b, cfg.n_masked)
        return {"items": items, "mask_pos": pos,
                "mask_labels": items.gather(1, pos.long())}
    fields = ids(pool, b, cfg.n_fields)
    first = cfg.n_fields - cfg.n_item_fields
    return {"fields": fields, "label": (fields[:, first] % 4 == 0).float()}


def _rs_vocab(cfg):
    """The rows an id may take: the table's (each field's for xDeepFM)."""
    return getattr(cfg, "field_vocab", None) or cfg.vocab


def _rs_serve(name, model, batch, rz):
    """The serving step: the forward (DIN, BST), ``_serve``'s top-10
    (BERT4Rec: its encoder is the forward), the forward in row chunks of
    ``xdfm_serve_chunk`` (xDeepFM: one CIN product of a 262,144-row batch
    would be 82 GB)."""
    from repro_torch.configs import bert4rec
    from repro_torch.models import recsys as R

    if name == "bert4rec":
        return bert4rec._serve(model, batch)
    if name == "xdeepfm":
        return torch.cat([R.xdeepfm_forward(model, f) for f in
                          batch["fields"].split(rz["xdfm_serve_chunk"])])
    return getattr(R, f"{name}_forward")(model, batch["hist"],
                                         batch["target"])


def _rs_retrieve(name, model, user, cand, rz):
    """``*_score_candidates`` for one user: DIN over the caller's candidate
    chunks (its (N, 100, 72) attention input would be 28.8 GB at 10^6),
    xDeepFM at ``chunk=xdfm_cand_chunk`` (its own scan)."""
    from repro_torch.models import recsys as R

    if name == "din":
        return torch.cat([R.din_score_candidates(model, user, c)
                          for c in cand.split(rz["din_cand_chunk"])])
    if name == "xdeepfm":
        return R.xdeepfm_score_candidates(model, user, cand,
                                          chunk=rz["xdfm_cand_chunk"])
    return getattr(R, f"{name}_score_candidates")(model, user, cand)


def _rs_pointwise(name, model, user, cand):
    """The forward on the tiled inputs of a retrieval: one row per
    candidate (BERT4Rec: the last hidden against each candidate's row)."""
    from repro_torch.models import recsys as R

    n = cand.shape[0]
    if name == "bert4rec":
        h = R.bert4rec_encode(model, user)[:, -1]
        return (h @ model.item_emb[cand.long()].T)[0]
    if name == "xdeepfm":
        return R.xdeepfm_forward(model, torch.cat(
            [user.expand(n, user.shape[1]), cand], dim=1))
    return getattr(R, f"{name}_forward")(model, user.expand(n,
                                                            user.shape[1]),
                                         cand)


def _rs_user(name, cfg, g, dev, n):
    """One user's side and n candidates, ids over the whole table."""
    def ids(hi, *shape):
        return torch.randint(0, hi, shape, generator=g, device=dev,
                             dtype=torch.int32)

    if name == "xdeepfm":
        k = cfg.n_item_fields
        return (ids(cfg.field_vocab, 1, cfg.n_fields - k),
                ids(cfg.field_vocab, n, k))
    return ids(cfg.vocab, 1, cfg.seq_len), ids(cfg.vocab, n)


def _rs_loss_fn(name, rz):
    from repro_torch.models import recsys as R

    if name == "bert4rec":
        return functools.partial(R.bert4rec_loss, chunk=rz["b4r_chunk"])
    return getattr(R, f"{name}_loss")


def _rs_serving(name, cfg, model, g, dev, rz):
    """(a) the serving step at each batch, (b) retrieval for one user, its
    slice against the forward on the tiled inputs."""
    out = dict(serve=[])
    for b in rz["serve"]:
        batch = {k: v for k, v in _rs_batch(name, cfg, b, g, dev,
                                            _rs_vocab(cfg)).items()
                 if k not in ("label", "mask_pos", "mask_labels")}
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        res = _rs_serve(name, model, batch, rz)
        first = res[0] if isinstance(res, tuple) else res
        require(first.shape[0] == b and bool(torch.isfinite(first).all()),
                f"{name} serve at {b}: shape {tuple(first.shape)} or "
                "non-finite scores")
        sec = _wall_s(lambda: _rs_serve(name, model, batch, rz),
                      rz["serve_reps"])
        row = dict(batch=b, ms=1e3 * sec, rows_per_s=b / sec)
        if dev.type == "cuda":
            row["max_memory_allocated"] = torch.cuda.max_memory_allocated()
            if b == max(rz["serve"]):
                row["trace"] = profile_batch(
                    lambda: _rs_serve(name, model, batch, rz))
        out["serve"].append(row)
        del batch, res, first
    user, cand = _rs_user(name, cfg, g, dev, rz["n_cand"])
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    scores = _rs_retrieve(name, model, user, cand, rz)
    require(scores.shape == (rz["n_cand"],)
            and bool(torch.isfinite(scores).all()),
            f"{name} retrieval: shape or non-finite scores")
    sec = _wall_s(lambda: _rs_retrieve(name, model, user, cand, rz),
                  rz["retrieve_reps"])
    n = rz["check_cands"]
    point = _rs_pointwise(name, model, user, cand[:n])
    err = float((scores[:n] - point).abs().max())
    scale = float(scores.abs().max())
    require(err <= RECSYS_SCORE_REL * scale,
            f"{name} retrieval vs forward on {n} tiled rows: {err:.3e} "
            f"(max |score| {scale:.3e})")
    out["retrieval"] = dict(n_candidates=rz["n_cand"], ms=1e3 * sec,
                            candidates_per_s=rz["n_cand"] / sec,
                            max_abs_err_vs_forward=err, max_abs_score=scale)
    if dev.type == "cuda":
        out["retrieval"]["max_memory_allocated"] = (
            torch.cuda.max_memory_allocated())
    return out


def _rs_train(name, cfg, model, g, dev, rz, rehearse):
    """(c) ``Trainer`` steps at the training batch on synthetic batches made
    on the card before the run; the forward / backward / optimizer split on
    one more batch; the tables' gradients nonzero."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    b, steps = rz["train"][name], rz["steps"]
    pool = min(rz["pool"], _rs_vocab(cfg))
    loss_fn = _rs_loss_fn(name, rz)
    opt = AdamWConfig(lr=rz["lr"], warmup_steps=rz["warmup"],
                      total_steps=steps, weight_decay=0.0)
    batches = [_rs_batch(name, cfg, b, g, dev, pool) for _ in range(steps + 1)]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    tr = Trainer(loss_fn, model, opt,
                 TrainerConfig(total_steps=steps, log_every=steps), device=dev)
    before = dict(fa.launches)
    res = tr.run(iter(batches[:steps]), log=lambda m: log("      " + m))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = {k: fa.launches[k] - before[k] for k in before}
    losses = res["losses"]
    tail = tr.step_times[2:]
    out = dict(batch=b, steps=steps, lr=opt.lr, warmup=opt.warmup_steps,
               pool=pool, losses=losses, launches=launches,
               step_ms=[1e3 * t for t in tr.step_times],
               step_ms_median=1e3 * statistics.median(tail),
               rows_per_s=b / statistics.median(tail))
    if dev.type == "cuda":
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    require(all(math.isfinite(x) for x in losses),
            f"{name}: a training loss is not finite: {losses}")
    fell = statistics.mean(losses[-3:]) < statistics.mean(losses[:3])
    out["fell"] = fell
    require(fell or rehearse, f"{name}: the loss did not fall: {losses}")
    extra = batches[steps]
    params = list(tr.params.parameters())
    out["forward_ms"] = 1e3 * _wall_s(lambda: loss_fn(tr.params, extra)[0],
                                      3)
    out["forward_backward_ms"] = 1e3 * _wall_s(
        lambda: torch.autograd.grad(loss_fn(tr.params, extra)[0], params), 3)
    out["backward_ms"] = out["forward_backward_ms"] - out["forward_ms"]
    out["optimizer_and_rest_ms"] = (out["step_ms_median"]
                                    - out["forward_backward_ms"])
    named = dict(tr.params.named_parameters())
    tables = [named[t] for t in RECSYS_TABLES[name]]
    grads = torch.autograd.grad(loss_fn(tr.params, extra)[0], tables)
    out["table_grad_abs_sum"] = {t: float(gr.abs().sum()) for t, gr in
                                 zip(RECSYS_TABLES[name], grads)}
    require(all(v > 0 for v in out["table_grad_abs_sum"].values()),
            f"{name}: a table's gradient is all zero: "
            f"{out['table_grad_abs_sum']}")
    del tr, batches, extra, params, named, tables, grads
    return out


def _rs_cut_copy(name, cfg, model, cut):
    """The model on the CPU with each table cut to its first ``cut`` rows
    (xDeepFM: each field's first ``cut`` rows; BERT4Rec's whole, as its
    loss runs over the catalogue); returns (the copy, its config, the rows
    of each table kept, on the card)."""
    import dataclasses

    from repro_torch.models import recsys as R

    dev = next(model.parameters()).device
    if name == "bert4rec":  # its loss is over the whole catalogue: kept
        cut = cfg.vocab
    if name == "xdeepfm":
        ccfg = dataclasses.replace(cfg, field_vocab=min(cut, cfg.field_vocab))
        rows = (torch.arange(cfg.n_fields, device=dev)[:, None]
                * cfg.field_vocab + torch.arange(ccfg.field_vocab,
                                                 device=dev)[None]).reshape(-1)
    else:
        ccfg = dataclasses.replace(cfg, vocab=min(cut, cfg.vocab))
        rows = torch.arange(ccfg.vocab, device=dev)
    cpu = getattr(R, f"{name}_init")(0, ccfg, device="cpu")
    src = dict(model.named_parameters())
    with torch.no_grad():
        for n, p in cpu.named_parameters():
            w = src[n][rows] if n in RECSYS_TABLES[name] else src[n]
            p.copy_(w.cpu())
    return cpu, ccfg, rows


def _rs_cross(name, cfg, model, g, dev, rz):
    """(d) the full config's weights on the card against a copy on the CPU
    with the tables cut; ids below the cut: logits (BERT4Rec: the last
    hidden against the catalogue), loss and every gradient."""
    from repro_torch.models import recsys as R

    cpu, ccfg, rows = _rs_cut_copy(name, cfg, model, rz["cross_rows"])
    batch = _rs_batch(name, ccfg, rz["cross_batch"], g, dev,
                      _rs_vocab(ccfg))
    loss_fn = _rs_loss_fn(name, rz)

    def run(m, b):
        with torch.no_grad():
            if name == "bert4rec":
                h = R.bert4rec_encode(m, b["items"])[:, -1]
                logits = h @ m.item_emb.T
            elif name == "xdeepfm":
                logits = R.xdeepfm_forward(m, b["fields"])
            else:
                logits = getattr(R, f"{name}_forward")(m, b["hist"],
                                                       b["target"])
        loss, _ = loss_fn(m, b)
        names = [n for n, _ in m.named_parameters()]
        grads = torch.autograd.grad(loss, list(m.parameters()))
        return logits, loss, dict(zip(names, grads))

    lg, ls, gg = run(model, batch)
    lw, lsw, gw = run(cpu, {k: v.cpu() for k, v in batch.items()})
    out = dict(cpu_table_rows=_rs_vocab(ccfg), batch=rz["cross_batch"])
    out["logit_rel"] = float((lg.cpu() - lw).abs().max() / lw.abs().max())
    out["loss_rel"] = float((ls.detach().cpu() - lsw.detach()).abs()
                            / lsw.detach().abs())
    floor = RECSYS_GRAD_FLOOR * max(float(w.abs().max()) for w in gw.values())
    share = {}  # each leaf's error over its limit
    for n, w in gw.items():
        got = gg[n][rows] if n in RECSYS_TABLES[name] else gg[n]
        err = float((got.cpu() - w).abs().max())
        lim = RECSYS_CROSS_REL * float(w.abs().max()) + floor
        require(err <= lim and bool(torch.isfinite(got).all()),
                f"{name} card vs CPU: gradient of {n} {err:.3e} > {lim:.3e}")
        share[n] = err / lim if lim else 0.0
    out["grad_err_over_limit"] = max(share.values())
    out["grad_worst_leaf"] = max(share, key=share.get)
    require(out["logit_rel"] <= RECSYS_CROSS_REL
            and out["loss_rel"] <= RECSYS_CROSS_REL,
            f"{name} card vs CPU: {out}")
    return out


def _rs_attention(dev, shapes, rehearse):
    """(e) the recommenders' attention against the plain versions: the SIMT
    forward (f32, non-causal) within phase 6's f32 limit, the backward on
    the route ``_backward_route`` picks within ``BWD_TOL`` (counted under
    it), each bit-equal on a second call; with times (CUDA events, graph
    replay) beside the bound (bytes over 3.35 TB/s, operations over 67
    TFLOP/s in f32; the tf32 route's three products at its tensor-core
    rate), the plain versions and SDPA's forward and backward."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(29)
    rows = []
    for role, b, h, s, dh, want_route in shapes:
        q, k, v = _attn_inputs(g, dev, b, h, s, s, dh, dh, F32)
        dout = torch.randn(b, h, s, dh, generator=g, device=dev)
        route = fa._backward_route(F32, dh, dh)
        require(route == want_route, f"{role}: backward route {route}")
        what = f"{role} attention {(b, h, s, dh)}"
        with torch.inference_mode():
            out = fa.flash_attention(q, k, v, causal=False)
            again = fa.flash_attention(q, k, v, causal=False)
            want = fa.flash_attention_plain(q, k, v, causal=False)
            out_l, lse = fa.flash_attention_lse(q, k, v, causal=False)
        fwd_err = _agree(out, want, ATTN_TOL[F32], what)
        require(torch.equal(out, again) and torch.equal(out, out_l),
                f"{what}: two forward calls differ")
        key = f"flash_attention_bwd_{route}"
        before = fa.launches[key]
        got = fa.flash_attention_bwd(q, k, v, out, dout, causal=False, lse=lse)
        again_b = fa.flash_attention_bwd(q, k, v, out, dout, causal=False,
                                         lse=lse)
        if dev.type == "cuda":
            require(fa.launches[key] == before + 2,
                    f"{what}: the backward not counted under {key}")
        gw = fa.flash_attention_bwd_plain(q, k, v, out, dout, causal=False)
        bwd_err = 0.0
        for x, w, name in zip(got, gw, ("dq", "dk", "dv")):
            e = float((x - w).abs().max())
            require(bool(torch.isfinite(x).all())
                    and e <= BWD_TOL[F32] * float(w.abs().max()),
                    f"{what}: {name} max err {e:.3e}")
            bwd_err = max(bwd_err, e)
        require(all(torch.equal(x, y) for x, y in zip(got, again_b)),
                f"{what}: two backward calls differ")
        pairs = b * h * s * s
        nbytes = 4 * 4 * q.numel()  # q, k, v read, out written
        row = dict(role=role, B=b, H=h, S=s, dh=dh, route=route,
                   fwd_max_abs_err=fwd_err, bwd_max_abs_err=bwd_err)
        row["bound_ms"], row["bound_by"] = bound(nbytes, 2 * 2 * dh * pairs)
        row["bwd_bound_ms"], row["bwd_bound_by"] = _bwd_bound(
            route, F32, 4 * (2 * 3 * q.numel() + 2 * out.numel()), pairs, dh,
            dh)
        if not rehearse:
            with torch.inference_mode():
                row["ms"] = time_ms(lambda: fa.flash_attention(
                    q, k, v, causal=False))
                row["device_ms"] = time_graph_ms(lambda: fa.flash_attention(
                    q, k, v, causal=False))
                row["plain_ms"] = time_ms(lambda: fa.flash_attention_plain(
                    q, k, v, causal=False), reps=5, inner=2)
                row["library_ms"] = time_ms(
                    lambda: F.scaled_dot_product_attention(q, k, v))
            run = lambda: fa._backward_card(q, k, v, out, dout, False,
                                            dh ** -0.5, lse)
            row["bwd_ms"] = time_ms(run)
            row["bwd_device_ms"] = time_graph_ms(run)
            row["bwd_plain_ms"] = time_ms(lambda: fa.flash_attention_bwd_plain(
                q, k, v, out, dout, causal=False), reps=5, inner=2)
            sdpa = _sdpa_backward(q, k, v, dout, False)
            row.update({f"bwd_{k}": v for k, v in sdpa.items()})
        rows.append(row)
        log("  (e) " + json.dumps({k: v for k, v in row.items()
                                   if "split" not in k}))
        del q, k, v, dout, out, again, want, out_l, lse, got, again_b, gw
    return rows


def recsys_slice(dev, sizes, rehearse):
    """Phase 14: the recommender models at ``sizes["recsys"]``'s configs,
    weights from each ``*_init`` with a seeded generator on the card. The
    path, its counts set to 0 first: per model (a) serving, (b) retrieval,
    (c) training; then (d) card against CPU and (e) the attention kernels
    against their plain versions."""
    import importlib

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import recsys as R

    rz = sizes["recsys"]
    out = dict(models={})
    if dev.type == "cuda":
        out["memory_allocated_at_start"] = torch.cuda.memory_allocated()
    fa.reset_launches()  # the path starts here
    t0 = time.perf_counter()
    for i, name in enumerate(RECSYS_MODELS):
        cfg = getattr(importlib.import_module(f"repro_torch.configs.{name}"),
                      rz["cfg"])()
        g = torch.Generator(device=dev).manual_seed(rz["seed"] + i)
        tm = time.perf_counter()
        model = getattr(R, f"{name}_init")(
            torch.Generator(device=dev).manual_seed(rz["seed"]), cfg)
        res = dict(config=cfg.name, params=sum(p.numel() for p in
                                               model.parameters()))
        with torch.inference_mode():  # serving records no autograd graph
            res.update(_rs_serving(name, cfg, model, g, dev, rz))
        log(f"  {name}: " + json.dumps(
            {"serve": [{k: v for k, v in r.items() if k != "trace"}
                       for r in res["serve"]], "retrieval": res["retrieval"]}))
        res["train"] = _rs_train(name, cfg, model, g, dev, rz, rehearse)
        del model
        tr = res["train"]
        log(f"  {name} (c): losses {json.dumps([round(x, 5) for x in tr['losses']])}; "
            f"step {tr['step_ms_median']:.3f} ms, {tr['rows_per_s']:.0f} "
            f"rows/s; forward {tr['forward_ms']:.3f}, backward "
            f"{tr['backward_ms']:.3f}, optimizer and the rest "
            f"{tr['optimizer_and_rest_ms']:.3f} ms; launches "
            f"{ {k: v for k, v in tr['launches'].items() if v} }; peak "
            f"{tr.get('max_memory_allocated')} bytes")
        res["s"] = time.perf_counter() - tm
        out["models"][name] = res
    if dev.type == "cuda":
        torch.cuda.synchronize()
    out["launches"] = dict(fa.launches)  # read just after the path
    out["path_s"] = time.perf_counter() - t0
    if not rehearse:
        bst_l = out["models"]["bst"]["train"]["launches"]
        b4r_l = out["models"]["bert4rec"]["train"]["launches"]
        require(bst_l["flash_attention_bwd_simt"] > 0
                and b4r_l["flash_attention_bwd_tf32"] > 0,
                f"the backward's simt (BST) and tf32 (BERT4Rec) routes must "
                f"both launch: {bst_l}, {b4r_l}")
        require(out["launches"]["flash_attention_simt"] > 0,
                "flash_attention was never launched on phase 14's path")
    for i, name in enumerate(RECSYS_MODELS):
        cfg = getattr(importlib.import_module(f"repro_torch.configs.{name}"),
                      rz["cfg"])()
        model = getattr(R, f"{name}_init")(
            torch.Generator(device=dev).manual_seed(rz["seed"]), cfg)
        g = torch.Generator(device=dev).manual_seed(rz["seed"] + 10 + i)
        out["models"][name]["cross"] = _rs_cross(name, cfg, model, g, dev, rz)
        log(f"  {name} (d) card vs CPU: "
            + json.dumps(out["models"][name]["cross"]))
        del model
    out["attention"] = _rs_attention(dev, rz["attn"], rehearse)
    return out


# --------------------------------------------------------------------------
# phase 15: MoE, MLA and the MTP head (granite-moe-3b-a800m at full size,
# deepseek-v3-671b at full widths with its depth cut)
# --------------------------------------------------------------------------
# card against CPU: f32 copies (the cut granite model: a router's top-k at
# bf16's rounding would flip near-ties between the two, f32 agrees to
# ~1e-7) within 1e-4 of max |logit| and 1e-5 (aux, z); bf16 on both sides
# where no router sees a rounding difference (the DS-V3 layer, moe_ffn on
# one input) within the towers' bf16 limits; the routing equal exactly.
MOE_F32_REL = 1e-4
MOE_LOSS_RTOL = 1e-5
MOE_GRAD_REL = 1e-4  # the card tests' gradient limit, x max |gradient|


@contextlib.contextmanager
def _counting_drops():
    """Within: ``transformer``'s ``moe_ffn`` also appends, for each call,
    (its (token, slot) assignments dropped at rank >= C, a device scalar;
    its assignments) to the yielded list. Kept out of timed runs."""
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T

    counts = []
    orig = T.moe_ffn

    def counting(module, x, cfg):
        d = x.shape[-1]
        t = x.numel() // d
        g = M.n_groups(cfg, t)
        c = M.capacity(cfg, t // g)
        _, _, _, e = M.route(module.router, x.reshape(g, t // g, d),
                             cfg.top_k)
        rows = cfg.n_experts * g * c  # dropped assignments go past them
        counts.append(((M.slots(e, cfg.n_experts, c) >= rows).sum(),
                       t * cfg.top_k))
        return orig(module, x, cfg)

    T.moe_ffn = counting
    try:
        yield counts
    finally:
        T.moe_ffn = orig


def moe_serve(dev, cfg, sz, rehearse, what):
    """(a)/(b): ``cfg`` drawn on the card from a seed, ``prefill`` of B
    prompts into a cache of ``max_seq``, then greedy ``decode_step``s, every
    step under ``set_sync_debug_mode("error")``; launches counted over the
    prefill and over the steps; prefill tokens/s, ms a step beside its byte
    bound (every weight the step reads, all experts included, the cache's
    valid part, the new entries), decode tokens/s, peak memory. The prefill
    runs twice, cold and warm (timed; the logits bit-equal); then one more
    step and prefill traced, and a prefill that counts the dropped
    assignments."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer as T

    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = T.init_params(sz["seed"], cfg, device=dev)
    sync()
    b, p, s, n = sz["batch"], sz["prompt"], sz["max_seq"], sz["steps"]
    out = dict(config=cfg.name, n_layers=cfg.n_layers, batch=b, prompt=p,
               max_seq=s, steps=n, init_s=time.perf_counter() - t0,
               params=sum(q.numel() for q in model.parameters()),
               weight_bytes=sum(q.numel() * q.element_size()
                                for q in model.parameters()))
    rng = np.random.default_rng(sz["seed"])
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (b, p))).to(dev)
    with torch.inference_mode():
        fa.reset_launches()  # the path starts here
        sync()
        t0 = time.perf_counter()
        logits, cache = T.prefill(model, prompts, max_seq=s)
        sync()
        out["prefill_first_s"] = time.perf_counter() - t0
        out["prefill_launches"] = {k: v for k, v in fa.launches.items() if v}
        require(tuple(logits.shape) == (b, 1, cfg.vocab)
                and bool(torch.isfinite(logits).all()),
                f"{what}: prefill logits {tuple(logits.shape)} or not finite")
        # the first call pays for loading kernels and growing the caching
        # allocator; the same prompts again, warm, must give the same bits
        del cache
        t0 = time.perf_counter()
        again, cache = T.prefill(model, prompts, max_seq=s)
        sync()
        out["prefill_s"] = time.perf_counter() - t0
        out["prefill_repeat_bit_equal"] = bool(torch.equal(again, logits))
        require(out["prefill_repeat_bit_equal"],
                f"{what}: two prefills of the same prompts differ")
        out["prefill_tokens_per_s"] = b * p / out["prefill_s"]
        if cuda:
            out["prefill_max_memory_allocated"] = torch.cuda.max_memory_allocated()
        tok = logits[:, -1].argmax(-1, keepdim=True)
        fa.reset_launches()  # the decode path starts here
        sync()
        t0 = time.perf_counter()
        if cuda:
            torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(n):
                lg, cache = T.decode_step(model, tok, cache)
                tok = lg[:, -1].argmax(-1, keepdim=True)
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode(0)
        sync()
        out["decode_s"] = time.perf_counter() - t0
        out["decode_launches"] = {k: v for k, v in fa.launches.items() if v}
        require(int(cache.length) == p + n and bool(torch.isfinite(lg).all()),
                f"{what}: cache length {int(cache.length)} or logits")
        if cuda:
            out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        out["ms_per_step"] = 1e3 * out["decode_s"] / n
        out["decode_tokens_per_s"] = b * n / out["decode_s"]
        item = torch.finfo(cfg.dtype).bits // 8
        row = (cfg.kv_lora_rank + cfg.qk_rope_dim if cfg.mla
               else 2 * cfg.n_kv_heads * cfg.head_dim)
        kv_row = cfg.n_layers * b * row * item
        # every weight but the retrieval and MTP heads' (every expert's too:
        # the expert products run over all of them, full slots or empty)
        weights = sum(q.numel() * q.element_size()
                      for k, q in model.named_parameters()
                      if not k.startswith(("embed_head", "mtp.")))
        step_bytes = weights + kv_row * (p + (n + 1) / 2 + 1)
        out["step_bytes"] = step_bytes
        out["step_bound_ms"] = 1e3 * step_bytes / HBM_BYTES_PER_S
        moe_layers = cfg.n_layers - cfg.n_dense
        out["expert_bytes_per_step"] = moe_layers * 3 * cfg.n_experts * \
            cfg.d_model * cfg.moe_d_ff * item
        if cfg.mla:  # the absorbed decode's f32 copy of one layer's cache
            out["mla_upcast_bytes_per_layer"] = b * s * row * 4
        if not rehearse:  # one more step and prefill, traced
            out["profile_step"] = profile_batch(
                lambda: T.decode_step(model, tok, cache))
            del cache
            out["profile_prefill"] = profile_batch(
                lambda: T.prefill(model, prompts, max_seq=s))
        # the prompts again, counting the dropped assignments of each MoE
        # layer on the device
        with _counting_drops() as counts:
            T.prefill(model, prompts, max_seq=s)
        dropped = sum(int(c) for c, _ in counts)
        total = sum(t for _, t in counts)
        out.update(prefill_assignments=total, prefill_dropped=dropped,
                   prefill_dropped_share=dropped / max(total, 1))
    if not rehearse:
        want_prefill = {"flash_attention_wgmma": cfg.n_layers}
        require(out["prefill_launches"] == want_prefill,
                f"{what}: prefill launched {out['prefill_launches']}, not "
                f"{want_prefill}")
        want_decode = {} if cfg.mla else {"flash_decode": cfg.n_layers * n}
        require(out["decode_launches"] == want_decode,
                f"{what}: decode launched {out['decode_launches']}, not "
                f"{want_decode}")
    del logits, again, lg
    log(f"  {what}: {out['params']:,} parameters ({out['weight_bytes']:,} "
        f"bytes) drawn in {out['init_s']:.3f} s; prefill {b} x {p} tokens "
        f"in {out['prefill_s']:.3f} s warm ({out['prefill_tokens_per_s']:.0f} "
        f"tokens/s; the first call {out['prefill_first_s']:.3f} s); {n} "
        f"decode steps {out['ms_per_step']:.3f} ms a step "
        f"(byte bound {out['step_bound_ms']:.3f} ms), "
        f"{out['decode_tokens_per_s']:.1f} tokens/s; dropped at prefill "
        f"{out['prefill_dropped']} of {out['prefill_assignments']} "
        f"({out['prefill_dropped_share']:.4%}); launches prefill "
        f"{out['prefill_launches']}, decode {out['decode_launches']}; peak "
        f"{out.get('max_memory_allocated')} bytes")
    log(f"      traced step {json.dumps(out.get('profile_step'))}; traced "
        f"prefill {json.dumps(out.get('profile_prefill'))}")
    return out, model


def _f32_agree(got, want, what):
    """``_logits_gap`` of rows (..., V) against ``want``'s, required within
    ``MOE_F32_REL`` of max |want|."""
    v = want.shape[-1]
    res = _logits_gap(got.reshape(-1, v), want.reshape(-1, v))
    require(bool(torch.isfinite(got).all()) and res["rel"] <= MOE_F32_REL,
            f"{what}: {res}")
    return res["rel"]


def moe_cross_granite(dev, model, cz):
    """(c) granite cut to its first layers, as f32 copies (its bf16 weights
    upcast exactly) on the card and the CPU: the forward's logits within
    ``MOE_F32_REL`` of max |logit|, aux and z within ``MOE_LOSS_RTOL``; then
    on the card at ``capacity_factor=16`` (no assignment dropped), decode =
    forward, JAX's ``test_decode_matches_forward`` on the full widths."""
    from repro_torch.models import transformer as T

    n = cz["cut_layers"]
    card = _cut_copy(model, n, dev, dtype=torch.float32)
    host = _cut_copy(model, n, "cpu", dtype=torch.float32)
    rng = np.random.default_rng(21)
    toks = torch.from_numpy(rng.integers(0, model.cfg.vocab,
                                         (cz["batch"], cz["seq"])))
    out = dict(layers=n, batch=cz["batch"], seq=cz["seq"], dtype="float32")
    with torch.inference_mode():
        oc = T.forward(card, toks.to(dev))
        oh = T.forward(host, toks)
        out["logits_rel"] = _f32_agree(oc.logits, oh.logits,
                                       "(c) granite cut, logits")
        for key in ("aux_loss", "z_loss"):
            a, b = float(getattr(oc, key)), float(getattr(oh, key))
            require(abs(a - b) <= MOE_LOSS_RTOL * abs(b),
                    f"(c) granite cut, {key} {a} vs {b}")
            out[key] = (a, b)
        del oc, oh, host
        card16 = _cut_copy(model, n, dev, dtype=torch.float32,
                           capacity_factor=16.0)
        p, steps = cz["decode_prompt"], cz["decode_steps"]
        seq = toks[:, :p + steps].to(dev)
        lg, cache = T.prefill(card16, seq[:, :p], max_seq=p + steps)
        worst = 0.0
        for i in range(steps):
            lg, cache = T.decode_step(card16, seq[:, p + i:p + i + 1], cache)
            ref = T.forward(card16, seq[:, :p + i + 1]).logits[:, -1]
            worst = max(worst, _f32_agree(lg[:, 0], ref,
                                          f"(c) decode step {i} vs forward"))
        out["decode_vs_forward_rel"] = worst
    del card, card16, cache
    log(f"  (c) granite cut to {n} layers, f32, card vs CPU: {out}")
    return out


def moe_cross_dsv3(dev, model, cz):
    """(c) DS-V3's first layer (MLA attention and a dense FFN) and its MoE
    cut to ``experts`` experts, each copied to the CPU in its own dtype: the
    attention's output and cache entries, the layer's output, and the
    absorbed decode of the last position (against the forward's last row,
    on both devices) within the towers' bf16 limits at B=1, S=``layer_seq``;
    then ``moe_ffn`` at T=31 (one group) and 64 (32 groups), the routing
    equal exactly, y within the bf16 limits, aux and z within
    ``MOE_LOSS_RTOL``."""
    from repro_torch.models import layers as L
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T

    cfg = model.cfg
    blk = model.blocks[0]
    host = T.Block(cfg, "cpu")
    host.load_state_dict(blk.state_dict())
    s = cz["layer_seq"]
    g = torch.Generator().manual_seed(22)
    x = torch.randn(1, s, cfg.d_model, generator=g).to(cfg.dtype)
    out = dict(layer_seq=s, dtype=str(cfg.dtype))
    with torch.inference_mode():
        res = {}
        for name, b, xx in (("card", blk, x.to(dev)), ("cpu", host, x)):
            pos = torch.arange(s, device=xx.device)
            xn = L.rms_norm(xx, b.ln1)
            a, ck, cr = b.attn.forward_kv(xn, pos)
            y = b.ffn_residual(xx + a)[0]
            cache_c = torch.zeros(1, s, cfg.kv_lora_rank, dtype=cfg.dtype,
                                  device=xx.device)
            cache_r = torch.zeros(1, s, cfg.qk_rope_dim, dtype=cfg.dtype,
                                  device=xx.device)
            cache_c[:, :s - 1], cache_r[:, :s - 1] = ck[:, :-1], cr[:, :-1]
            length = torch.tensor(s - 1, dtype=torch.int32, device=xx.device)
            dec = T._decode_attn_mla(b.attn, xn[:, -1:], cache_c, cache_r,
                                     length)
            res[name] = dict(attn=a[0], c_kv=ck[0], k_rope=cr[0], layer=y[0],
                             decode=dec[0])
            out[f"{name}_decode_vs_forward"] = _logits_agree(
                dec[0], a[0, -1:], f"(c) {name} MLA decode vs forward")
        for key in ("attn", "c_kv", "k_rope", "layer"):
            out[key] = _logits_agree(res["card"][key], res["cpu"][key],
                                     f"(c) DS-V3 layer 0 {key}, card vs CPU")
        del res, host
        # the MoE layer's first experts, on both devices
        src = model.blocks[cfg.n_dense].moe
        e = cz["experts"]
        mcfg = src.cfg._replace(n_experts=e)
        state = {k: (v[:, :e] if k == "router" else
                     v[:e] if k.startswith("w_") else v)
                 for k, v in src.state_dict().items()}
        mods = {}
        for name, d in (("card", dev), ("cpu", "cpu")):
            mods[name] = M.MoE(mcfg, d)
            mods[name].load_state_dict(state)
        out["moe"] = dict(experts=e, top_k=mcfg.top_k, d_model=mcfg.d_model,
                          d_ff=mcfg.d_ff, n_shared=mcfg.n_shared, rows=[])
        for t in cz["tokens"]:
            xt = torch.randn(t, cfg.d_model, generator=g).to(cfg.dtype)
            grp = M.n_groups(mcfg, t)
            c = M.capacity(mcfg, t // grp)
            got = {}
            for name, d in (("card", dev), ("cpu", "cpu")):
                xd = xt.to(d)
                got[name] = (M.moe_ffn(mods[name], xd, mcfg), M.route(
                    mods[name].router, xd.view(grp, t // grp, -1),
                    mcfg.top_k)[3])
            (oc, ec), (oh, eh) = got["card"], got["cpu"]
            require(torch.equal(ec.cpu(), eh),
                    f"(c) moe_ffn T={t}: the routing differs")
            row = dict(T=t, groups=grp, capacity=c, dropped=int(
                (M.slots(eh, e, c) >= e * grp * c).sum()),
                       y=_logits_agree(oc.y, oh.y, f"(c) moe_ffn T={t} y"))
            for key in ("aux_loss", "z_loss"):
                a, b = float(getattr(oc, key)), float(getattr(oh, key))
                require(abs(a - b) <= MOE_LOSS_RTOL * abs(b),
                        f"(c) moe_ffn T={t} {key} {a} vs {b}")
                row[key] = (a, b)
            out["moe"]["rows"].append(row)
        del mods, got
    log(f"  (c) DS-V3 layer 0 and moe_ffn ({e} experts), card vs CPU: "
        + json.dumps(out))
    return out


def moe_train(dev, tz, rehearse):
    """(d) ``loss_fn`` (ce, aux, z; DS-V3's mtp_ce) and every gradient of
    both smoke configs (f32, the cross entropy in chunks) on the card
    against a CPU copy; then ``launch/train.py --preset smoke`` for both
    archs on the card, finite losses."""
    import dataclasses

    from repro_torch.configs import deepseek_v3_671b, granite_moe_3b_a800m
    from repro_torch.launch import train as launch_train
    from repro_torch.models import transformer as T

    out = {}
    for arch, mod in (("granite-moe-3b-a800m", granite_moe_3b_a800m),
                      ("deepseek-v3-671b", deepseek_v3_671b)):
        cfg = dataclasses.replace(mod.smoke(), ce_chunk=tz["ce_chunk"])
        card = T.init_params(tz["seed"], cfg, device=dev)
        host = T.Transformer(cfg, device="cpu")
        host.load_state_dict(card.state_dict())
        toks = np.random.default_rng(23).integers(
            0, cfg.vocab, (tz["batch"], tz["seq"] + 1))
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        lc, mc = T.loss_fn(card, batch)
        lh, mh = T.loss_fn(host, batch)
        require(set(mc) == set(mh) and ("mtp_ce" in mc) == cfg.mtp,
                f"(d) {arch}: metrics {sorted(mc)}")
        res = dict(metrics={k: (float(mc[k].detach()), float(mh[k].detach()))
                            for k in mh})
        for k, (a, b) in res["metrics"].items():
            require(abs(a - b) <= MOE_LOSS_RTOL * abs(b),
                    f"(d) {arch}: {k} {a} vs {b}")
        lc.backward()
        lh.backward()
        worst = 0.0
        for (name, pc), ph in zip(card.named_parameters(),
                                  host.parameters()):
            if ph.grad is None:
                require(pc.grad is None, f"(d) {arch}: {name} has a grad")
                continue
            err = float((pc.grad.cpu() - ph.grad).abs().max())
            lim = MOE_GRAD_REL * float(ph.grad.abs().max()) + 1e-12
            require(err <= lim, f"(d) {arch}: {name} grad err {err:.3e}")
            worst = max(worst, err / lim)
        res["worst_grad_share_of_limit"] = worst
        del card, host, lc, lh
        trainer, r = launch_train.main([
            "--arch", arch, "--preset", "smoke", "--steps", str(tz["steps"]),
            "--batch", str(tz["launch_batch"]), "--seq",
            str(tz["launch_seq"]), "--device", dev.type])
        require(len(r["losses"]) == tz["steps"]
                and all(math.isfinite(x) for x in r["losses"]),
                f"(d) {arch} launcher losses {r['losses']}")
        res["launcher_losses"] = r["losses"]
        del trainer
        out[arch] = res
        log(f"  (d) {arch}: " + json.dumps(res))
    return out


def _sdpa_backend(*args, **kwargs):
    """The backend ``F.scaled_dot_product_attention(*args, **kwargs)``
    dispatches to (``torch._fused_sdp_choice``, the selector SDPA itself
    calls), by its ``SDPBackend`` name."""
    from torch.nn.attention import SDPBackend

    return SDPBackend(torch._fused_sdp_choice(*args, **kwargs)).name


# the plain attention's f32 scores past this many bytes go a batch row at a
# time (granite-20b's prefill layer would hold 25.8 GB of them at once)
PLAIN_SCORE_BYTES = 8 << 30


def attention_kernel_rows(dev, mz, rehearse):
    """``flash_attention`` at ``mz["attn"]``'s prefill layers (bf16 causal;
    grouped heads read k and v repeated to H, as ``blockwise_attention``
    copies them) and ``flash_decode`` at ``mz["decode"]``'s grouped caches
    (seeded lengths), each against its plain version within phase 6's
    full-width limit, timed (eager, graph replay) beside its bound, the
    plain version and SDPA (``enable_gqa`` for the grouped rows), with the
    backend SDPA picks. Phase 15(e) and phase 17(d)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(31)
    rows = []
    for role, b, h, hkv, s, dh, dv in mz["attn"]:
        rep = h // hkv
        q = torch.randn(b, h, s, dh, generator=g, device=dev).to(BF16)
        k_g = torch.randn(b, hkv, s, dh, generator=g, device=dev).to(BF16)
        v_g = torch.randn(b, hkv, s, dv, generator=g, device=dev).to(BF16)
        k = k_g.repeat_interleave(rep, 1)
        v = v_g.repeat_interleave(rep, 1)
        gqa = {"enable_gqa": True} if rep > 1 else {}
        run = lambda: fa.flash_attention(q, k, v, causal=True)
        lib = lambda: F.scaled_dot_product_attention(q, k_g, v_g,
                                                     is_causal=True, **gqa)
        by_row = 4 * b * h * s * s > PLAIN_SCORE_BYTES
        plain = ((lambda: torch.cat([fa.flash_attention_plain(
            q[i:i + 1], k[i:i + 1], v[i:i + 1], causal=True)
            for i in range(b)])) if by_row else
                 (lambda: fa.flash_attention_plain(q, k, v, causal=True)))
        before = dict(fa.launches)
        with torch.inference_mode():
            got = run()
            want = plain()
        launched = [n for n in fa.launches if fa.launches[n] > before[n]]
        require(rehearse or launched == ["flash_attention_wgmma"],
                f"{role}: launched {launched}")
        atol, rtol = MAIN_TOL[BF16]
        row = dict(kernel="flash_attention", role=role, B=b, H=h, Hkv=hkv,
                   S=s, dh=dh, dv=dv, dtype="bfloat16", causal=True,
                   route=launched, plain_by_batch_row=by_row,
                   max_abs_err=_agree(got, want, atol, what=role, rtol=rtol),
                   library_backend=_sdpa_backend(q, k_g, v_g, is_causal=True,
                                                 **gqa))
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + got.numel())
        row["bound_ms"], row["bound_by"] = bound(
            nbytes, 2 * (dh + dv) * b * h * s * (s + 1) // 2,
            BF16_OPS_PER_S)
        del got, want
        if not rehearse:
            with torch.inference_mode():
                row["ms"] = time_ms(run)
                row["device_ms"] = time_graph_ms(run)
                row["plain_ms"] = time_ms(plain, reps=3, inner=1)
                row["library_ms"] = time_ms(lib)
        rows.append(row)
        log("  " + json.dumps(row))
        del q, k, v, k_g, v_g
    for role, b, h, hkv, s, d in mz["decode"]:
        q, k, v = _decode_inputs(g, dev, b, h, s, d, d, BF16, hkv)
        length = torch.randint(1, s + 1, (b,), generator=g, device=dev,
                               dtype=torch.int32)
        valid = int(length.sum())
        mask = (torch.arange(s, device=dev)[None, :] < length[:, None])[
            :, None, None]
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)
        run = lambda: fa.flash_decode(q, k, v, length=length)
        lib = lambda: F.scaled_dot_product_attention(
            q[:, :, None], kt, vt, attn_mask=mask, enable_gqa=True)[:, :, 0]
        before = fa.launches["flash_decode"]
        with torch.inference_mode():
            got = run()
            want = fa.flash_decode_plain(q, k, v, length=length)
        require(rehearse or fa.launches["flash_decode"] == before + 1,
                f"{role}: flash_decode not launched once")
        atol, rtol = MAIN_TOL[BF16]
        row = dict(kernel="flash_decode", role=role, B=b, H=h, Hkv=hkv, S=s,
                   dh=d, dv=d, dtype="bfloat16", valid_keys=valid,
                   chunk=fa.decode_split(s, b * h)[0],
                   max_abs_err=_agree(got, want, atol, what=role, rtol=rtol),
                   library_backend=_sdpa_backend(
                       q[:, :, None], kt, vt, attn_mask=mask,
                       enable_gqa=True))
        row["bound_ms"], row["bound_by"] = bound(
            2 * (valid * hkv * 2 * d + 2 * b * h * d) + 4 * b,
            2 * 2 * d * h * valid, BF16_OPS_PER_S)
        if not rehearse:
            with torch.inference_mode():
                row["ms"] = time_ms(run)
                row["device_ms"] = time_graph_ms(run)
                row["plain_ms"] = time_ms(lambda: fa.flash_decode_plain(
                    q, k, v, length=length), reps=5, inner=2)
                row["library_ms"] = time_ms(lib)
        rows.append(row)
        log("  " + json.dumps(row))
    return rows


def moe_slice(dev, sizes, rehearse):
    """Phase 15: MoE, MLA and MTP at ``sizes["moe"]``: (a) granite-moe-3b-
    a800m at full size and (b) deepseek-v3-671b at full widths with its
    depth cut, each served (prefill, then decode steps) with launches
    counted from 0 over each, and (c) held against CPU copies at full
    widths; (d) the smoke configs' loss and gradients card = CPU, and the
    launcher; (e) the attention kernels at the new shapes."""
    import gc

    mz = sizes["moe"]
    out = {}
    for key, what in (("granite", "(a) granite-moe-3b-a800m"),
                      ("dsv3", "(b) deepseek-v3-671b, depth cut")):
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            out[f"{key}_memory_allocated_at_start"] = \
                torch.cuda.memory_allocated()
        cfg = mz[key]["cfg"]()
        res, model = moe_serve(dev, cfg, mz[key], rehearse, what)
        cross = moe_cross_dsv3 if cfg.mla else moe_cross_granite
        res["cross"] = cross(dev, model, mz["cross"])
        out[key] = res
        del model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["train"] = moe_train(dev, mz["train"], rehearse)
    out["attention"] = attention_kernel_rows(dev, mz, rehearse)
    return out


# --------------------------------------------------------------------------
# phase 16: the GAT graph model
# --------------------------------------------------------------------------
GNN_LOGIT_REL = 1e-5  # card vs CPU: max |logit diff| over max |logit|
GNN_LOSS_RTOL = 1e-5
GNN_GRAD_REL = 1e-4  # x the leaf's max |gradient| on the CPU
# or, for a leaf whose f32 gradient cannot hold GNN_GRAD_REL (a sum over
# every edge whose terms nearly cancel, as layer 2's attention vectors'
# do: the softmax does not see a shift that every edge of a node shares),
# this many times f32's own noise in it: the card's gradient against itself
# with the edges permuted (every sum in another order)
GNN_NOISE = 4.0


def gnn_sizes(rehearse):
    """Phase 16's sizes, a function of its own so that the phase can run
    alone (``gnn_slice(dev, gnn_sizes(False), False)``): the four shapes of
    ``configs/gat_cora.GNN_SHAPES``; the Reddit-size CSR graph (232,965
    nodes, 114.6 M edges) minibatch_lg's blocks are sampled from, 1,024
    seeds at fanouts (15, 10); the card-against-CPU graph of 131,072 nodes
    at ogb_products' mean degree, summed in chunks of 2^20 edges; 10
    training steps; 5 full-batch steps at ogb_products, its split timed
    once; the corpus-search twin at ogbn-arxiv's size (169,343 nodes, mean
    degree 7, 128 features), 64 queries. Toy sizes under ``rehearse``."""
    from repro_torch.configs import gat_cora

    train = dict(steps=10, lr=1e-3, warmup=2)
    full_train = dict(steps=5, split_reps=1)
    if not rehearse:
        return dict(shapes=gat_cora.GNN_SHAPES, seed=0, fwd_reps=(11, 5),
                    big_reps=(3, 1), reddit=(232965, 492, 602, 41),
                    seeds=1024, fanouts=(15, 10),
                    cross=dict(n=131072, chunk=1 << 20), train=train,
                    full_train=full_train,
                    search=dict(n=169343, degree=7, d_feat=128, queries=64,
                                quotas=(64, 256)))
    toy = {"full_graph_sm": dict(true_nodes=240, true_edges=480),
           "minibatch_lg": dict(n_nodes=160, n_edges=160),
           "ogb_products": dict(true_nodes=250, true_edges=500),
           "molecule": dict(true_nodes=240, true_edges=512)}
    return dict(shapes={k: dict(gat_cora.SMOKE_SHAPES[k], **v)
                        for k, v in toy.items()},
                seed=0, fwd_reps=(1, 1), big_reps=(1, 1),
                reddit=(2000, 20, 32, 41), seeds=16, fanouts=(3, 2),
                cross=dict(n=512, chunk=1000), train=train,
                full_train=full_train,
                search=dict(n=512, degree=7, d_feat=16, queries=8,
                            quotas=(32, 64)))


def _gnn_rule(d_feat, n_classes, g):
    """A fixed random projection (d_feat, n_classes), drawn on ``g``'s
    device."""
    return torch.randn(d_feat, n_classes, generator=g, device=g.device)


def _gnn_scores(feats, src, dst, rule, chunk=1 << 24):
    """(N, C): each node's in-neighbours' features summed and projected by
    ``rule`` (invalid edges skipped). Labels follow its argmax: a GAT has
    no self-loops, so a node's own features never reach its logits, its
    in-neighbours' do."""
    proj = feats @ rule.to(feats.device)
    out = torch.zeros_like(proj)
    for c0 in range(0, src.shape[0], chunk):
        s, t = src[c0:c0 + chunk].long(), dst[c0:c0 + chunk].long()
        keep = (s >= 0)[:, None].to(proj.dtype)
        out.index_add_(0, t.clamp(min=0), proj[s.clamp(min=0)] * keep)
    return out


def _gnn_uniform(info, g, dev):
    """A node-task batch at ``info``'s sizes: ``true_nodes`` nodes with
    normal features and ``true_edges`` uniformly random edges among them,
    padded to ``n_nodes`` (zero features, mask 0) and ``n_edges`` (-1
    edges); labels by :func:`_gnn_scores`."""
    n, e = info["n_nodes"], info["n_edges"]
    tn, te = info["true_nodes"], info["true_edges"]
    feats = torch.randn(n, info["d_feat"], generator=g, device=dev)
    feats[tn:] = 0.0
    src, dst = torch.randint(0, tn, (2, e), generator=g, device=dev,
                             dtype=torch.int32)
    src[te:] = -1
    dst[te:] = -1
    rule = _gnn_rule(info["d_feat"], info["n_classes"], g)
    labels = _gnn_scores(feats, src, dst, rule).argmax(-1).to(torch.int32)
    mask = (torch.arange(n, device=dev) < tn).float()
    return dict(feats=feats, src=src, dst=dst, labels=labels, mask=mask)


def _gnn_molecules(info, g, dev):
    """``n_graphs`` disjoint graphs of ``true_nodes / n_graphs`` nodes and
    ``true_edges / n_graphs`` random edges each; the pad nodes past them
    (zero features) get graph id ``n_graphs``, which the readout drops;
    each graph's label is the argmax of its nodes' :func:`_gnn_scores`
    summed."""
    ng, n = info["n_graphs"], info["n_nodes"]
    per_n, per_e = info["true_nodes"] // ng, info["true_edges"] // ng
    base = (torch.arange(ng * per_e, device=dev) // per_e) * per_n
    ends = torch.randint(0, per_n, (2, ng * per_e), generator=g, device=dev)
    src, dst = (ends + base).to(torch.int32)
    pad = torch.full((info["n_edges"] - ng * per_e,), -1, dtype=torch.int32,
                     device=dev)
    src, dst = torch.cat([src, pad]), torch.cat([dst, pad])
    feats = torch.randn(n, info["d_feat"], generator=g, device=dev)
    feats[ng * per_n:] = 0.0
    gid = (torch.arange(n, device=dev) // per_n).clamp(max=ng).to(torch.int32)
    scores = _gnn_scores(feats, src, dst,
                         _gnn_rule(info["d_feat"], info["n_classes"], g))
    per_graph = torch.zeros(ng + 1, scores.shape[1], device=dev).index_add_(
        0, gid.long(), scores)[:ng]
    return dict(feats=feats, src=src, dst=dst, graph_ids=gid,
                graph_labels=per_graph.argmax(-1).to(torch.int32))


def _gnn_blocks(graph, gz, rule, rng, dev, sampler_s):
    """minibatch_lg's batches: each a fresh ``sample_block`` of
    ``gz["seeds"]`` seeds drawn from ``rng`` at ``gz["fanouts"]`` (its host
    seconds appended to ``sampler_s``), labelled by :func:`_gnn_scores` on
    the block's own edges, on ``dev``."""
    from repro_torch.models import gnn

    while True:
        seeds = rng.choice(graph.indptr.shape[0] - 1, gz["seeds"],
                           replace=False)
        t0 = time.perf_counter()
        blk = gnn.sample_block(graph, seeds, gz["fanouts"], rng)
        sampler_s.append(time.perf_counter() - t0)
        b = {k: torch.from_numpy(getattr(blk, k))
             for k in ("feats", "src", "dst", "mask")}
        b["labels"] = _gnn_scores(b["feats"], b["src"], b["dst"],
                                  rule).argmax(-1).to(torch.int32)
        yield {k: v.to(dev) for k, v in b.items()}


def _gnn_reckon(n, e, cfg):
    """Bytes a forward adds above its inputs and weights, reckoned from the
    shapes alone (f32): the edge plan (~6 int64 an edge: keys, order,
    sorted ends) and the costliest layer's h (N, H·dh), five (E, H)
    per-edge tensors, two chunks of messages (C, H·dh) and three (N, H·dh)
    sums."""
    from repro_torch.models import gnn

    worst = 0
    for i in range(cfg.n_layers):
        dh = cfg.n_classes if i == cfg.n_layers - 1 else cfg.d_hidden
        hd = cfg.n_heads * dh
        c = gnn.edge_chunk(e, n, cfg.n_heads, dh)
        worst = max(worst, 4 * (4 * n * hd + 5 * e * cfg.n_heads + 2 * c * hd))
    return 6 * 8 * e + 8 * (n + 1) + worst


def _gnn_forward(dev, shape, model, batch, reps, rehearse):
    """(a) A forward at the shape's full size: the first call, the warm
    time, nodes/s and edges/s, a traced call's device split
    (:func:`profile_batch`); a second call bit-equal to the first and a
    third under ``set_sync_debug_mode("error")``; peak memory above the
    inputs beside :func:`_gnn_reckon`; the edge chunks of each layer and
    the bytes the literal (E, H, dh) messages and gathered rows would
    take."""
    from repro_torch.models import gnn

    cfg = model.cfg
    n, e = batch["feats"].shape[0], batch["src"].shape[0]
    run = lambda: gnn.forward(model, batch["feats"], batch["src"],
                              batch["dst"])
    dims = [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]
    out = dict(shape=shape, n_nodes=n, n_edges=e, d_feat=cfg.d_in,
               n_classes=cfg.n_classes, reckoned_bytes=_gnn_reckon(n, e, cfg),
               chunks=[gnn.edge_chunk(e, n, cfg.n_heads, d) for d in dims],
               literal_bytes=[2 * 4 * e * cfg.n_heads * d for d in dims])
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        t0 = time.perf_counter()
        first = run()
        if cuda:
            torch.cuda.synchronize()
        out["first_s"] = time.perf_counter() - t0
        require(first.shape == (n, cfg.n_classes)
                and bool(torch.isfinite(first).all()),
                f"(a) {shape}: logits {tuple(first.shape)} or not finite")
        require(torch.equal(run(), first), f"(a) {shape}: a second forward "
                "is not bit-equal to the first")
        if cuda:  # a forward that reads nothing back to the host
            torch.cuda.set_sync_debug_mode("error")
        try:
            third = run()
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode(0)
        require(torch.equal(third, first), f"(a) {shape}: the forward under "
                "the sync guard differs")
        if cuda:
            out["peak_bytes_above_inputs"] = (torch.cuda.max_memory_allocated()
                                              - start)
        if not rehearse:
            out["ms"] = time_ms(run, reps=reps[0], inner=reps[1], warmup=1)
            out["nodes_per_s"] = n / out["ms"] * 1e3
            out["edges_per_s"] = e / out["ms"] * 1e3
            out["trace"] = profile_batch(run)
    out.update(bit_equal=True, no_host_sync=cuda)
    del first, third
    log(f"  (a) {shape}: " + json.dumps(out))
    if shape == "ogb_products":
        log(f"  (a) ogb_products: largest edge chunk {max(out['chunks']):,} "
            f"edges; the literal form's (E, H, dh) messages and gathered "
            f"rows at the last layer: 2 x {out['literal_bytes'][-1] / 2e9:.1f}"
            f" GB")
    return out


def _gnn_loss(info, chunk=None):
    """``graph_loss`` bound to the shape's task and graph count, as JAX's
    ``build_gnn_cell`` binds it."""
    from repro_torch.configs import gat_cora

    return functools.partial(gat_cora.graph_loss, task=info["task"],
                             n_graphs=info.get("n_graphs") or 0, chunk=chunk)


def _gnn_cross(shape, info, model, batch, chunk=None, saved=False):
    """(b) The model and batch on the card against a CPU copy, both with
    ``chunk``: logits within ``GNN_LOGIT_REL`` of max |logit|, the loss
    within ``GNN_LOSS_RTOL``, every gradient per leaf within
    ``GNN_GRAD_REL`` x its max |gradient| or ``GNN_NOISE`` x its f32
    noise, whichever is larger (the bias unused on both); the leaves that
    needed the noise term are reported. In more than one chunk the
    gradients are the backward's that recomputes the softmax and each
    chunk; with ``saved``, also autograd's saved form on the card (the
    edges in one chunk), each leaf within ``GNN_NOISE`` x its f32 noise of
    the recomputed one, the loss within ``GNN_LOSS_RTOL``."""
    from repro_torch.models import gnn

    host = gnn.GAT(model.cfg, "cpu")
    host.load_state_dict(model.state_dict())
    hb = {k: v.cpu() for k, v in batch.items()}
    loss = _gnn_loss(info, chunk)
    res = dict(shape=shape, n_nodes=batch["feats"].shape[0],
               n_edges=batch["src"].shape[0], chunk=chunk)
    with torch.no_grad():
        a = gnn.forward(model, batch["feats"], batch["src"], batch["dst"],
                        chunk=chunk).cpu()
        b = gnn.forward(host, hb["feats"], hb["src"], hb["dst"], chunk=chunk)
    res["logits_rel"] = float((a - b).abs().max() / b.abs().max())
    require(res["logits_rel"] <= GNN_LOGIT_REL,
            f"(b) {shape}: logits {res['logits_rel']:.3e} of max")
    perm = torch.randperm(batch["src"].shape[0], device=batch["src"].device,
                          generator=torch.Generator(
                              device=batch["src"].device).manual_seed(5))
    permuted = dict(batch, src=batch["src"][perm], dst=batch["dst"][perm])
    grads = []
    for m, bb in ((model, batch), (host, hb), (model, permuted)):
        lo, _ = loss(m, bb)
        gs = torch.autograd.grad(lo, list(m.parameters()), allow_unused=True)
        grads.append((float(lo.detach()), gs))
    (lc, gc), (lh, gh), (_, gp) = grads
    res["loss"] = (lc, lh)
    require(abs(lc - lh) <= GNN_LOSS_RTOL * abs(lh),
            f"(b) {shape}: loss {lc} vs {lh}")
    if saved:
        lo, _ = _gnn_loss(info, res["n_edges"])(model, batch)
        gs = torch.autograd.grad(lo, list(model.parameters()),
                                 allow_unused=True)
        res["saved_loss"] = float(lo.detach())
        require(abs(res["saved_loss"] - lc) <= GNN_LOSS_RTOL * abs(lc),
                f"(b) {shape}: the saved form's loss {res['saved_loss']} vs "
                f"the recomputed one's {lc}")
        res["saved_vs_recomputed"] = {}
        for (name, _), x, y, z in zip(host.named_parameters(), gc, gs, gp):
            if y is None:
                continue
            err = float((x - y).abs().max())
            noise = float((z - x).abs().max())
            require(err <= GNN_NOISE * noise, f"(b) {shape}: {name} saved "
                    f"vs recomputed grad {err:.3e}, f32 noise {noise:.3e}")
            res["saved_vs_recomputed"][name] = dict(err=err, noise=noise)
        del gs
    worst, res["noise_limited"] = 0.0, {}
    for (name, _), x, y, z in zip(host.named_parameters(), gc, gh, gp):
        if y is None:
            require(x is None and z is None and name.endswith("bias"),
                    f"(b) {shape}: {name} unused on one device only")
            continue
        err = float((x.cpu() - y).abs().max())
        plain = GNN_GRAD_REL * float(y.abs().max())
        noise = float((z - x).abs().max())
        lim = max(plain, GNN_NOISE * noise)
        require(err <= lim, f"(b) {shape}: {name} grad err {err:.3e}, "
                f"limit {plain:.3e}, f32 noise {noise:.3e}")
        if err > plain:
            res["noise_limited"][name] = dict(err=err, plain_limit=plain,
                                              noise=noise)
        worst = max(worst, err / lim)
    res["worst_grad_share_of_limit"] = worst
    log(f"  (b) {shape}: " + json.dumps(res))
    return res


def _gnn_train(dev, shape, info, model, batches, tz, rehearse, fixed):
    """(c) ``tz["steps"]`` ``Trainer`` steps (AdamW lr ``tz["lr"]``, warmup
    ``tz["warmup"]``, no weight decay) on ``batches``: the losses finite,
    and falling on a ``fixed`` batch; step ms with its forward / backward /
    optimizer split (on the last batch), peak memory."""
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    steps = tz["steps"]
    loss = _gnn_loss(info)
    opt = AdamWConfig(lr=tz["lr"], warmup_steps=tz["warmup"],
                      total_steps=steps, weight_decay=0.0)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    tr = Trainer(loss, model, opt,
                 TrainerConfig(total_steps=steps, log_every=steps), device=dev)
    seen = {}

    def feed():  # keeps the last batch for the split below
        for b in batches:
            seen["last"] = b
            yield b

    res = tr.run(feed(), log=lambda m: log("      " + m))
    losses = res["losses"]
    tail = tr.step_times[2:]
    out = dict(shape=shape, steps=steps, fixed_batch=fixed, losses=losses,
               step_ms=[1e3 * t for t in tr.step_times],
               step_ms_median=1e3 * statistics.median(tail))
    if dev.type == "cuda":
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    require(all(math.isfinite(x) for x in losses),
            f"(c) {shape}: a loss is not finite: {losses}")
    out["fell"] = statistics.mean(losses[-3:]) < statistics.mean(losses[:3])
    require(out["fell"] or rehearse or not fixed,
            f"(c) {shape}: the loss did not fall: {losses}")
    last = seen["last"]
    params = list(tr.params.parameters())
    out["forward_ms"] = 1e3 * _wall_s(lambda: loss(tr.params, last)[0], 3)
    out["forward_backward_ms"] = 1e3 * _wall_s(lambda: torch.autograd.grad(
        loss(tr.params, last)[0], params, allow_unused=True), 3)
    out["backward_ms"] = out["forward_backward_ms"] - out["forward_ms"]
    out["optimizer_and_rest_ms"] = (out["step_ms_median"]
                                    - out["forward_backward_ms"])
    log(f"  (c) {shape}: " + json.dumps(out))
    del tr, seen, last
    return out


def _gnn_train_reckon(n, e, cfg):
    """Bytes a training step adds above its inputs and weights, reckoned
    from the shapes alone (f32), beside what the literal backward would
    keep: the edge plan (src and dst as int64, valid); what the backward
    keeps of each layer (its (E, H) coefficients, h and its output (N,
    H·dh), e_src and e_dst (N, H)); then the larger of one chunk's
    backward at the costliest layer (its rows, messages and their two
    gradients, four (C, H·dh); the (N, H·dh) gradient of h twice; the (E,
    H) gradient of the coefficients twice) and one layer's softmax
    recomputed with its gradients (nine (E, H)). ``literal``: each layer's
    (E, H·dh) rows and messages and six (E, H) softmax tensors, all kept."""
    from repro_torch.models import gnn

    out = dict(plan=17 * e + 8 * (n + 1), kept=0, transient=0, literal=0)
    for i in range(cfg.n_layers):
        dh = cfg.n_classes if i == cfg.n_layers - 1 else cfg.d_hidden
        h, hd = cfg.n_heads, cfg.n_heads * dh
        c = gnn.edge_chunk(e, n, h, dh)
        out["kept"] += 4 * (e * h + 2 * n * hd + 2 * n * h)
        out["transient"] = max(out["transient"],
                               4 * (4 * c * hd + 2 * n * hd + 2 * e * h),
                               4 * 9 * e * h)
        out["literal"] += 4 * (2 * e * hd + 6 * e * h + 2 * n * hd)
    out["total"] = out["plan"] + out["kept"] + out["transient"]
    return out


def _gnn_train_full(dev, shape, model, batch, want_loss, ez, rehearse):
    """(e) ``ez["steps"]`` full-batch steps of the shape's cell,
    ``gat_cora.build_gnn_cell(None, shape).fn`` (AdamW ``OPT``), on (a)'s
    batch: the cell's abstract batch equal to it in shape and dtype; step
    0's loss bit-equal to ``want_loss`` (the forward's loss under no
    grad); the losses falling; step ms, the forward / backward / optimizer
    split, peak memory above the inputs beside :func:`_gnn_train_reckon`."""
    from repro_torch.configs import gat_cora
    from repro_torch.train.optimizer import make_adamw

    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cell = gat_cora.build_gnn_cell(None, shape, smoke=rehearse)
    _, _, b_abs = cell.abstract_args()
    require({k: (tuple(v.shape), v.dtype) for k, v in b_abs.items()}
            == {k: (tuple(v.shape), v.dtype) for k, v in batch.items()},
            f"(e) {shape}: the batch is not the cell's")
    n, e = batch["feats"].shape[0], batch["src"].shape[0]
    out = dict(shape=shape, cell=cell.name, steps=ez["steps"], n_nodes=n,
               n_edges=e, reckoned=_gnn_train_reckon(n, e, model.cfg))
    opt = make_adamw(gat_cora.OPT)[0](model)
    if cuda:
        sync()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    for _ in range(ez["steps"]):
        sync()
        t0 = time.perf_counter()
        model, opt, metrics = cell.fn(model, opt, batch)
        sync()
        step_s.append(time.perf_counter() - t0)
        losses.append(metrics["loss"])
    if cuda:
        out["peak_bytes_above_inputs"] = torch.cuda.max_memory_allocated() - start
        out["card_bytes"] = torch.cuda.get_device_properties(dev).total_memory
    out["step0_bit_equal_forward"] = bool(torch.equal(losses[0].cpu(),
                                                      want_loss.cpu()))
    out["losses"] = [float(x) for x in losses]
    out["step_ms"] = [1e3 * t for t in step_s]
    out["step_ms_median"] = 1e3 * statistics.median(step_s[1:] or step_s)
    require(all(math.isfinite(x) for x in out["losses"]),
            f"(e) {shape}: a loss is not finite: {out['losses']}")
    require(out["step0_bit_equal_forward"], f"(e) {shape}: step 0's loss "
            f"{out['losses'][0]!r} is not the forward's "
            f"{float(want_loss)!r}")
    require(out["losses"][-1] < out["losses"][0],
            f"(e) {shape}: the loss did not fall: {out['losses']}")
    params = list(model.parameters())
    loss = _gnn_loss(gat_cora.GNN_SHAPES[shape])
    reps = ez["split_reps"]
    out["forward_ms"] = 1e3 * _wall_s(lambda: loss(model, batch)[0], reps)
    out["forward_backward_ms"] = 1e3 * _wall_s(lambda: torch.autograd.grad(
        loss(model, batch)[0], params, allow_unused=True), reps)
    out["backward_ms"] = out["forward_backward_ms"] - out["forward_ms"]
    out["optimizer_and_rest_ms"] = (out["step_ms_median"]
                                    - out["forward_backward_ms"])
    log(f"  (e) {shape}: " + json.dumps(out))
    if cuda:
        log(f"  (e) {shape}: peak {out['peak_bytes_above_inputs'] / 1e9:.2f} "
            f"GB above the inputs, reckoned {out['reckoned']['total'] / 1e9:.2f}"
            f" GB (the literal backward would keep "
            f"{out['reckoned']['literal'] / 1e9:.1f} GB) on a "
            f"{out['card_bytes'] / 1e9:.1f} GB card")
    return out


def _gnn_search(sz, dev, rehearse):
    """(d) ``launch/gnn_corpus_search.main`` on the card at ``sz``'s size,
    the search kernels' launches counted from 0 over it: each query within
    Q D calls, both kernels launched; then one wave of each metric held
    against the plain versions (:func:`check_tower_waves`)."""
    from repro_torch.kernels import l2_topk
    from repro_torch.launch import gnn_corpus_search

    argv = ["--n-nodes", str(sz["n"]), "--avg-degree", str(sz["degree"]),
            "--d-feat", str(sz["d_feat"]), "--n-queries", str(sz["queries"]),
            "--quotas", ",".join(map(str, sz["quotas"])),
            "--device", dev.type]
    l2_topk.reset_launches()  # the path starts here
    t0 = time.perf_counter()
    res = gnn_corpus_search.main(argv)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = dict(l2_topk.launches)  # read just after the path
    out = dict(argv=argv, run_s=time.perf_counter() - t0, launches=launches,
               **{k: res[k] for k in ("n_nodes", "n_edges", "embed_s",
                                      "build_s", "recall_at_10", "query_s")},
               max_D_calls={q: max(c) for q, c in res["D_calls"].items()})
    for q, calls in res["D_calls"].items():
        require(len(calls) == sz["queries"] and max(calls) <= q,
                f"(d) D calls {max(calls)} past the quota {q}")
    if not rehearse:
        for name in ("gather_score", "beam_merge_topk"):
            require(launches[name] > 0,
                    f"(d) {name} was never launched on the GNN search")
    st = res["state"]
    emb = {("cheap", "docs"): st["emb_d"], ("cheap", "queries"): st["q_d"],
           ("expensive", "docs"): st["emb_D"],
           ("expensive", "queries"): st["q_D"]}
    out["wave_checks"] = check_tower_waves(st["index"], emb, sz["quotas"])
    log(f"  (d) corpus search: " + json.dumps(
        {k: v for k, v in out.items() if k != "wave_checks"}))
    return out


def gnn_slice(dev, gz, rehearse):
    """Phase 16: the GAT at gat-cora's widths (2 layers, 8 heads, d_hidden
    8), f32, weights from ``init_params`` on the card: per shape (a) the
    forward at full size, (b) card against CPU (ogb_products' model on the
    131,072-node graph, in chunks smaller than E, the saved backward beside
    the recomputed one), (c) training (ogb_products: (e), full-batch
    steps of its cell on (a)'s batch, before (b)); then (d) the
    corpus-search twin."""
    import gc

    from repro_torch.configs import gat_cora
    from repro_torch.models import gnn

    t_start = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(gz["seed"])
    shapes, tz = gz["shapes"], gz["train"]
    out = {}
    for shape in ("full_graph_sm", "molecule", "minibatch_lg",
                  "ogb_products"):
        info = shapes[shape]
        model = gnn.init_params(g, (gat_cora.smoke if rehearse
                                    else gat_cora.full)(shape))
        res = out[shape] = {}
        if shape == "minibatch_lg":
            t0 = time.perf_counter()
            graph = gnn.random_csr_graph(*gz["reddit"], seed=gz["seed"])
            res["host_graph_s"] = time.perf_counter() - t0
            res["host_graph_edges"] = int(graph.indptr[-1])
            rule = _gnn_rule(info["d_feat"], info["n_classes"],
                             torch.Generator().manual_seed(gz["seed"]))
            sampler_s = []
            blocks = _gnn_blocks(graph, gz, rule,
                                 np.random.default_rng(gz["seed"]), dev,
                                 sampler_s)
            batch = next(blocks)
            require(batch["feats"].shape[0] == info["n_nodes"]
                    and batch["src"].shape[0] == info["n_edges"],
                    f"(a) minibatch_lg: block {batch['feats'].shape[0]} "
                    f"nodes, {batch['src'].shape[0]} edges")
        elif shape == "molecule":
            batch = _gnn_molecules(info, g, dev)
        else:
            batch = _gnn_uniform(info, g, dev)
        reps = gz["big_reps"] if shape == "ogb_products" else gz["fwd_reps"]
        res["forward"] = _gnn_forward(dev, shape, model, batch, reps,
                                      rehearse)
        if shape == "ogb_products":
            with torch.no_grad():
                want = _gnn_loss(info)(model, batch)[0]
            res["train_full"] = _gnn_train_full(dev, shape, model, batch,
                                                want, gz["full_train"],
                                                rehearse)
            del batch, want
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            cz = gz["cross"]
            e = round(cz["n"] * info["true_edges"] / info["true_nodes"])
            small = dict(info, n_nodes=cz["n"], n_edges=e, true_nodes=cz["n"],
                         true_edges=e)
            batch = _gnn_uniform(small, g, dev)
            require(cz["chunk"] < e, "(b) the chunk is not smaller than E")
            res["cross"] = _gnn_cross(shape, small, model, batch,
                                      cz["chunk"], saved=True)
        else:
            res["cross"] = _gnn_cross(shape, info, model, batch)
            fresh = blocks if shape == "minibatch_lg" else itertools.repeat(
                batch)
            res["train"] = _gnn_train(dev, shape, info, model, fresh, tz,
                                      rehearse, fixed=shape != "minibatch_lg")
        if shape == "minibatch_lg":
            res["sampler_ms"] = [1e3 * s for s in sampler_s]
            log(f"  (c) minibatch_lg: the sampler's host ms a block "
                f"{statistics.median(res['sampler_ms']):.1f} (median of "
                f"{len(sampler_s)}); the host graph took "
                f"{res['host_graph_s']:.1f} s")
            del graph, blocks
        del model, batch
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    out["search"] = _gnn_search(gz["search"], dev, rehearse)
    out["phase_s"] = time.perf_counter() - t_start
    return out


# --------------------------------------------------------------------------
# phase 17: the dense LMs of the registry, granite-20b (MQA, 48 query heads
# over 1) and deepseek-coder-33b (GQA, 56 over 8), at full width on the card
# --------------------------------------------------------------------------
# bf16 decode logits against the forward's on the same tokens: the least
# cosine of a row (max |diff| over max |logit| reported, not gated); fixed
# before the first run. In f32 at 2 layers, decode against forward and card
# against CPU within MOE_F32_REL (1e-4) of max |logit|.
DENSE_COS = 0.99
DENSE_ARCHS = ("granite-20b", "deepseek-coder-33b")


def dense_lm_sizes(rehearse):
    """Phase 17's sizes, a function of its own so that the phase can run
    alone (``dense_lm_slice(dev, dense_lm_sizes(False), False)``):
    granite-20b at full depth, 8 prompts of 4,096 tokens into caches of
    4,160 and 64 decode steps, its decode_32k cell at B=8 (cut from 128);
    deepseek-coder-33b at full depth, 4 prompts, its decode_32k cell at
    B=1 (its cache costs 254 KB a token: B=4 would not fit beside the
    weights); 64 documents of 256 tokens through ``embed_pool``; 8 steps
    at decode_32k; card against CPU in f32 cut to 2 layers at B=2, 64
    prompt tokens and 4 steps; the kernels at both prefill layers and both
    decode_32k caches. The smoke configs at toy sizes under ``rehearse``."""
    if not rehearse:
        each = dict(seed=0, prompt=4096, max_seq=4160, docs=(64, 256),
                    decode_steps=8)
        return dict(
            models=(dict(each, arch="granite-20b", batch=8, decode_batch=8),
                    dict(each, arch="deepseek-coder-33b", batch=4,
                         decode_batch=1)),
            smoke=False, cross=dict(cut_layers=2, batch=2, prompt=64, steps=4),
            attn=(("granite-20b prefill layer, 48 over 1", 8, 48, 1, 4096,
                   128, 128),
                  ("deepseek-coder-33b prefill layer, 56 over 8", 4, 56, 8,
                   4096, 128, 128)),
            decode=(("granite-20b decode_32k, B 128 cut to 8, MQA 48 over 1",
                     8, 48, 1, 32768, 128),
                    ("deepseek-coder-33b decode_32k, B 128 cut to 1, 56 over "
                     "8 (a group of 7)", 1, 56, 8, 32768, 128)))
    each = dict(seed=0, batch=2, prompt=24, max_seq=32, docs=(4, 16),
                decode_batch=2, decode_steps=2)
    return dict(models=(dict(each, arch="granite-20b"),
                        dict(each, arch="deepseek-coder-33b")),
                smoke=True, cross=dict(cut_layers=1, batch=2, prompt=8,
                                       steps=2),
                attn=(("granite-20b layer, toy", 1, 4, 1, 64, 16, 16),
                      ("deepseek-coder-33b layer, toy", 1, 8, 2, 64, 8, 8)),
                decode=(("granite-20b decode, toy", 2, 4, 1, 128, 16),
                        ("deepseek-coder-33b decode, toy", 1, 8, 2, 128, 8)))


def _dense_need_bytes(spec, cfg, mz, decode_seq):
    """Bytes phase 17 must place for ``cfg`` at full depth, from the shapes
    on the meta device: the weights and the larger of the prefill's cache
    (``batch`` x ``max_seq``) and decode_32k's (``decode_batch`` x
    ``decode_seq``)."""
    from repro_torch.configs import common

    meta = common.abstract_params(spec.model, cfg)
    weights = sum(p.numel() * p.element_size() for p in meta.parameters())
    kv_token = (2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim
                * torch.finfo(cfg.dtype).bits // 8)
    return weights + kv_token * max(mz["batch"] * mz["max_seq"],
                                    mz["decode_batch"] * decode_seq)


def _step_weight_bytes(model):
    """Bytes of the weights a decode step reads: all but the retrieval
    head's."""
    return sum(q.numel() * q.element_size() for k, q in model.named_parameters()
               if not k.startswith("embed_head"))


def dense_serve(dev, spec, cfg, mz, rehearse, what):
    """(a) ``cfg`` drawn in bf16 on the card from a seed; the prefill_32k
    cell's ``fn`` on B prompts into a cache of ``max_seq`` (twice: cold,
    then warm and timed, bit-equal), then the decode_32k cell's ``fn`` for
    greedy steps that fill it, every step under
    ``set_sync_debug_mode("error")``; launches counted from 0 over the
    prefill (one ``flash_attention_wgmma`` a layer) and over the steps (one
    ``flash_decode`` a layer a step); the first and last step's logits
    against the forward's on the same tokens (``DENSE_COS`` a row); prefill
    tokens/s, ms a step beside its byte bound, peak memory; then
    ``embed_pool`` (D's use) on ``docs`` documents, twice, bit-equal."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer as T

    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = spec.init_params(mz["seed"], cfg, device=dev)
    sync()
    prefill_fn = spec.build_cell(cfg, "prefill_32k", smoke=rehearse).fn
    decode_fn = spec.build_cell(cfg, "decode_32k", smoke=rehearse).fn
    b, p, s = mz["batch"], mz["prompt"], mz["max_seq"]
    n = s - p
    out = dict(config=cfg.name, n_layers=cfg.n_layers, batch=b, prompt=p,
               max_seq=s, steps=n, init_s=time.perf_counter() - t0,
               params=sum(q.numel() for q in model.parameters()),
               weight_bytes=sum(q.numel() * q.element_size()
                                for q in model.parameters()))
    rng = np.random.default_rng(mz["seed"])
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (b, p))).to(dev)
    with torch.inference_mode():
        fa.reset_launches()  # the prefill path starts here
        sync()
        t0 = time.perf_counter()
        logits, cache = prefill_fn(model, prompts, max_seq=s)
        sync()
        out["prefill_first_s"] = time.perf_counter() - t0
        out["prefill_launches"] = {k: v for k, v in fa.launches.items() if v}
        require(tuple(logits.shape) == (b, 1, cfg.vocab)
                and bool(torch.isfinite(logits).all()),
                f"{what}: prefill logits {tuple(logits.shape)} or not finite")
        del cache
        t0 = time.perf_counter()
        again, cache = prefill_fn(model, prompts, max_seq=s)
        sync()
        out["prefill_s"] = time.perf_counter() - t0
        out["prefill_repeat_bit_equal"] = bool(torch.equal(again, logits))
        require(out["prefill_repeat_bit_equal"],
                f"{what}: two prefills of the same prompts differ")
        out["prefill_tokens_per_s"] = b * p / out["prefill_s"]
        if cuda:
            out["prefill_max_memory_allocated"] = \
                torch.cuda.max_memory_allocated()
        toks = [logits[:, -1].argmax(-1, keepdim=True)]
        fa.reset_launches()  # the decode path starts here
        sync()
        t0 = time.perf_counter()
        if cuda:
            torch.cuda.set_sync_debug_mode("error")
        try:
            for i in range(n):
                lg, cache = decode_fn(model, toks[-1], cache)
                if i == 0:
                    first = lg
                toks.append(lg[:, -1].argmax(-1, keepdim=True))
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode(0)
        sync()
        out["decode_s"] = time.perf_counter() - t0
        out["decode_launches"] = {k: v for k, v in fa.launches.items() if v}
        require(int(cache.length) == s and bool(torch.isfinite(lg).all()),
                f"{what}: cache length {int(cache.length)} or logits")
        if cuda:
            out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
            # the caching allocator's retries (frees and a new cudaMalloc)
            # after a failed allocation, so far in the process
            out["alloc_retries"] = torch.cuda.memory_stats().get(
                "num_alloc_retries")
        out["ms_per_step"] = 1e3 * out["decode_s"] / n
        out["decode_tokens_per_s"] = b * n / out["decode_s"]
        item = torch.finfo(cfg.dtype).bits // 8
        kv_row = cfg.n_layers * b * 2 * cfg.n_kv_heads * cfg.head_dim * item
        out["step_bytes"] = (_step_weight_bytes(model)
                             + kv_row * (p + (n + 1) / 2 + 1))
        out["step_bound_ms"] = 1e3 * out["step_bytes"] / HBM_BYTES_PER_S
        del cache, again
        # the references: the forward on the same tokens
        seq = torch.cat([prompts] + toks[:-1], dim=1)
        for name, lgt, upto in (("first", first, p + 1), ("last", lg, s)):
            hid = T.forward(model, seq[:, :upto], with_logits=False).hidden
            res = _logits_gap(lgt[:, 0], hid[:, -1] @ model.embed.T)
            require(bool(torch.isfinite(lgt).all())
                    and res["min_cos"] >= DENSE_COS,
                    f"{what}: decode step {name} vs forward {res}")
            out[f"{name}_step_vs_forward"] = res
            del hid
        # the retrieval embedding, D's use of the model
        docs = torch.from_numpy(rng.integers(0, cfg.vocab, mz["docs"])).to(
            dev)
        fa.reset_launches()  # the embedding path starts here
        emb = T.embed_pool(model, docs)
        sync()
        out["embed_launches"] = {k: v for k, v in fa.launches.items() if v}
        t0 = time.perf_counter()
        emb2 = T.embed_pool(model, docs)
        sync()
        out["embed_s"] = time.perf_counter() - t0
        out["embed_docs_per_s"] = mz["docs"][0] / out["embed_s"]
        norms = emb.norm(dim=-1)
        require(tuple(emb.shape) == (mz["docs"][0], cfg.embed_dim)
                and bool(torch.isfinite(emb).all())
                and bool(((norms - 1).abs() < 1e-4).all())
                and torch.equal(emb, emb2),
                f"{what}: embed_pool {tuple(emb.shape)}, norms or repeat")
        del emb, emb2
    if not rehearse:
        want = {"flash_attention_wgmma": cfg.n_layers}
        require(out["prefill_launches"] == want
                and out["embed_launches"] == want,
                f"{what}: prefill launched {out['prefill_launches']}, "
                f"embed_pool {out['embed_launches']}, not {want}")
        want = {"flash_decode": cfg.n_layers * n}
        require(out["decode_launches"] == want,
                f"{what}: decode launched {out['decode_launches']}, not "
                f"{want}")
    log(f"  {what} (a): {out['params']:,} parameters "
        f"({out['weight_bytes']:,} bytes) drawn in {out['init_s']:.3f} s; "
        f"prefill {b} x {p} tokens "
        f"in {out['prefill_s']:.3f} s warm ({out['prefill_tokens_per_s']:.0f} "
        f"tokens/s; the first call {out['prefill_first_s']:.3f} s); {n} "
        f"decode steps {out['ms_per_step']:.3f} ms a step (byte bound "
        f"{out['step_bound_ms']:.3f} ms); embed_pool of {mz['docs']} in "
        f"{out['embed_s']:.3f} s; launches prefill {out['prefill_launches']}"
        f", decode {out['decode_launches']}, embed {out['embed_launches']}; "
        f"peak {out.get('max_memory_allocated')} bytes")
    log(f"      first step vs forward {out['first_step_vs_forward']}; last "
        f"{out['last_step_vs_forward']}")
    return out, model


def dense_decode_32k(dev, spec, cfg, model, mz, rehearse, what):
    """(b) The decode_32k cell: its abstract cache's shape with the batch
    cut to ``decode_batch``, filled with seeded random k and v at length S
    - 1; one step, then ``decode_steps`` steps of its ``fn`` timed, each
    under ``set_sync_debug_mode("error")`` (one ``flash_decode`` a layer a
    step); ms a step beside its byte bound (the weights and the whole
    cache), a traced step's idle share, peak memory."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer as T

    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cell = spec.build_cell(cfg, "decode_32k", smoke=rehearse)
    _, tok_abs, c_abs = cell.abstract_args()
    b, s, n = mz["decode_batch"], c_abs.k.shape[2], mz["decode_steps"]
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    cache = T.init_cache(cfg, b, s, length=s - 1, device=dev)
    want = (c_abs.k.shape[0], b, *c_abs.k.shape[2:])
    require(tuple(cache.k.shape) == want == tuple(cache.v.shape)
            and cache.k.dtype == c_abs.k.dtype and tok_abs.shape[1] == 1,
            f"{what}: cache {tuple(cache.k.shape)} is not the cell's {want}")
    g = torch.Generator(device=dev).manual_seed(mz["seed"] + 7)
    with torch.no_grad():
        for layer in range(cfg.n_layers):
            cache.k[layer].normal_(generator=g)
            cache.v[layer].normal_(generator=g)
    toks = torch.randint(0, cfg.vocab, (b, 1), generator=g, device=dev)
    out = dict(batch=b, batch_cut_from=c_abs.k.shape[1], cache_len=s,
               steps=n, cache_bytes=2 * cache.k.numel() * cache.k.element_size())
    with torch.inference_mode():
        lg, cache = cell.fn(model, toks, cache)  # warm
        fa.reset_launches()  # the timed steps start here
        sync()
        t0 = time.perf_counter()
        if cuda:
            torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(n):
                lg, cache = cell.fn(model, lg[:, -1].argmax(-1, keepdim=True),
                                    cache)
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode(0)
        sync()
        out["decode_s"] = time.perf_counter() - t0
        out["launches"] = {k: v for k, v in fa.launches.items() if v}
        require(bool(torch.isfinite(lg).all()) and int(cache.length) == s + n,
                f"{what}: logits or cache length {int(cache.length)}")
        out["ms_per_step"] = 1e3 * out["decode_s"] / n
        out["step_bytes"] = _step_weight_bytes(model) + out["cache_bytes"]
        out["step_bound_ms"] = 1e3 * out["step_bytes"] / HBM_BYTES_PER_S
        if cuda:
            out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
            out["alloc_retries"] = torch.cuda.memory_stats().get(
                "num_alloc_retries")
        if not rehearse:
            out["profile_step"] = profile_batch(lambda: cell.fn(
                model, lg[:, -1].argmax(-1, keepdim=True), cache))
            require(out["launches"] == {"flash_decode": cfg.n_layers * n},
                    f"{what}: launched {out['launches']}")
    del cache, lg
    log(f"  {what} (b): decode_32k at B={b} (cut from {out['batch_cut_from']}), "
        f"cache {out['cache_bytes']:,} bytes: {out['ms_per_step']:.3f} ms a "
        f"step (byte bound {out['step_bound_ms']:.3f} ms); traced step "
        f"{json.dumps(out.get('profile_step'))}; peak "
        f"{out.get('max_memory_allocated')} bytes")
    return out


def dense_cross(dev, model, cz, what):
    """(c) The model cut to its first layers as f32 copies (its bf16
    weights upcast exactly) on the card and the CPU: the forward's logits
    card against CPU; ``prefill`` card against CPU; each ``decode_step``
    card against CPU and against the card's forward at its position; each
    within ``MOE_F32_REL`` of max |logit|."""
    from repro_torch.models import transformer as T

    n = cz["cut_layers"]
    card = _cut_copy(model, n, dev, dtype=torch.float32)
    host = _cut_copy(model, n, "cpu", dtype=torch.float32)
    p, steps = cz["prompt"], cz["steps"]
    toks = torch.from_numpy(np.random.default_rng(21).integers(
        0, model.cfg.vocab, (cz["batch"], p + steps)))
    out = dict(layers=n, batch=cz["batch"], prompt=p, steps=steps,
               dtype="float32")
    with torch.inference_mode():
        fc = T.forward(card, toks.to(dev)).logits
        out["forward_rel"] = _f32_agree(fc, T.forward(host, toks).logits,
                                        f"{what} (c) forward, card vs CPU")
        lc, cc = T.prefill(card, toks[:, :p].to(dev), max_seq=p + steps)
        lh, ch = T.prefill(host, toks[:, :p], max_seq=p + steps)
        out["prefill_rel"] = _f32_agree(lc, lh, f"{what} (c) prefill")
        out["decode_rel"] = out["decode_vs_forward_rel"] = 0.0
        for i in range(steps):
            tok = toks[:, p + i:p + i + 1]
            lc, cc = T.decode_step(card, tok.to(dev), cc)
            lh, ch = T.decode_step(host, tok, ch)
            out["decode_rel"] = max(out["decode_rel"], _f32_agree(
                lc, lh, f"{what} (c) decode step {i}, card vs CPU"))
            out["decode_vs_forward_rel"] = max(
                out["decode_vs_forward_rel"], _f32_agree(
                    lc[:, 0], fc[:, p + i],
                    f"{what} (c) decode step {i} vs forward"))
    del card, host, cc, ch
    log(f"  {what} (c) cut to {n} layers, f32: {out}")
    return out


def dense_lm_slice(dev, dz, rehearse):
    """Phase 17: granite-20b and deepseek-coder-33b through their registry
    cells (``get_arch(name).build_cell``), one at a time, each drawn in
    bf16 on the card at full depth (the phase fails, naming the bytes, if
    the weights and caches do not fit): (a) prefill and decode, embed_pool;
    (b) decode_32k; (c) card against CPU at 2 layers in f32; then (d)
    ``flash_attention`` and ``flash_decode`` at their shapes against the
    plain versions."""
    import gc

    from repro_torch.configs import get_arch, lm_common

    shapes = lm_common.SMOKE_SHAPES if rehearse else lm_common.LM_SHAPES
    out = {}
    for mz in dz["models"]:
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        spec = get_arch(mz["arch"])
        cfg = spec.make_config(dz["smoke"])
        what = f"({mz['arch']})"
        res = dict(need_bytes=_dense_need_bytes(
            spec, cfg, mz, shapes["decode_32k"]["seq_len"]))
        if dev.type == "cuda":
            res["memory_allocated_at_start"] = torch.cuda.memory_allocated()
            res["free_at_start"] = torch.cuda.mem_get_info(dev)[0]
            require(res["need_bytes"] <= res["free_at_start"],
                    f"{what}: {cfg.n_layers} layers need "
                    f"{res['need_bytes']:,} bytes of weights and cache, "
                    f"{res['free_at_start']:,} free")
        serve, model = dense_serve(dev, spec, cfg, mz, rehearse, what)
        res.update(serve)
        res["decode_32k"] = dense_decode_32k(dev, spec, cfg, model, mz,
                                             rehearse, what)
        res["cross"] = dense_cross(dev, model, dz["cross"], what)
        out[mz["arch"]] = res
        del model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["attention"] = attention_kernel_rows(dev, dz, rehearse)
    return out


# --------------------------------------------------------------------------
# phase 18: training on a mesh
# --------------------------------------------------------------------------
MESH_NOISE = 4.0  # the mesh against the unsharded step, x the f32 noise
# an f32 step's gradient norm and moments: the noise, or this share of
# their max (the CPU tests' limit for the mesh step's state)
MESH_F32_FLOOR = 1e-5
# the f32 copy's moments, each tensor against its own max: its gradients
# are sums over 8,192 tokens, which the mesh forms in other groupings than
# the unsharded kernels
MESH_F32_MOMENTS = 1e-4
# the router of an MoE layer where the f32 copy's mesh step routed some
# (token, slot) assignment to another expert than its unsharded step did
# (a near-tie of two probabilities, broken by f32's rounding), and the
# norm whose output it reads: a swap of a token's first two slots moves
# two experts' top-1 counts, so the aux loss's gradient reaches every
# token's router logits otherwise
MESH_F32_FLIPPED_ROUTER = 1e-3


def mesh_sizes(rehearse):
    """Phase 18: (a) qwen3-0.6b at train_4k's sequence with the batch cut
    to 2, 3 steps on a (2, 2) mesh; (b) GPipe over its blocks as 4 stages
    (2 in a rehearsal), 4 microbatches of 1 row; (d) granite-moe-3b-a800m
    at full width with its depth cut to 4 layers, batch 2 at 4,096, 2
    steps; (e) BST's train_batch cell (65,536 rows), 2 steps; the two
    attention kernels at a model shard's heads of (a) and (d). The smoke
    configs at toy sizes in a rehearsal."""
    attn = ((("qwen3-0.6b's train_4k, a model shard's heads: 8 over 4 of "
              "16 over 8", 1, 8, 4, 4096, 128, 128),
             ("granite-moe-3b-a800m's train_4k, a model shard's heads: 12 "
              "over 4 of 24 over 8", 1, 12, 4, 4096, 64, 64))
            if not rehearse else
            (("qwen3 shard, toy", 1, 2, 1, 64, 32, 32),
             ("granite-moe shard, toy", 1, 2, 1, 64, 16, 16)))
    return dict(arch="qwen3-0.6b", smoke=rehearse, seed=0, batch=2,
                seq=64 if rehearse else 4096, steps=3,
                stages=2 if rehearse else 4, n_micro=4,
                moe=dict(arch="granite-moe-3b-a800m", layers=4, batch=2,
                         seq=64 if rehearse else 4096, steps=2),
                recsys=dict(arch="bst", steps=2, pool=1 << 16),
                attn=attn)


def _max_gap(a: dict, b: dict) -> float:
    return max(float((a[n].float() - b[n].float()).abs().max()) for n in b)


def _shares(a: dict, b: dict):
    """[(share, name, gap, that tensor's max |b|)] of every tensor, its
    largest gap as a share of its own max |b| (a gap where b is all 0
    counts as infinite), the largest share first."""
    out = []
    for n in b:
        g = float((a[n].float() - b[n].float()).abs().max())
        t = float(b[n].float().abs().max())
        out.append((g / t if t else (math.inf if g else 0.0), n, g, t))
    return sorted(out, reverse=True)


@contextlib.contextmanager
def _recording_routes():
    """Within: every ``moe.plan`` call appends its (T, K) expert ids and
    (T, E) router probabilities, detached, to the yielded list (both the
    unsharded ``moe_ffn`` and the tensor-parallel ``moe_rows`` route
    through it)."""
    from repro_torch.models import moe as M

    seen = []
    orig = M.plan

    def recording(router, xt, cfg, g, cap):
        res = orig(router, xt, cfg, g, cap)
        seen.append((res[3].detach().reshape(-1, cfg.top_k).clone(),
                     res[1].detach().reshape(-1, cfg.n_experts).clone()))
        return res

    M.plan = recording
    try:
        yield seen
    finally:
        M.plan = orig


def _route_flips(unsharded, mesh, routers, n_rows):
    """Each MoE layer's routing in a step's forward, the mesh's against the
    unsharded step's: ``unsharded`` holds the forward's calls first (one a
    layer), ``mesh`` one a data row a layer, rows in batch order.
    {router name: (token, slot) assignments whose expert differs, tokens
    whose set of experts differs, the largest gap of the unsharded step's
    probabilities between the two experts of a differing assignment,
    tokens whose top-1 expert differs}."""
    out = {}
    for i, name in enumerate(routers):
        ue, up = unsharded[i]
        me = torch.cat([mesh[i * n_rows + r][0] for r in range(n_rows)])
        diff = ue != me
        sets = (ue.sort(-1).values != me.sort(-1).values).any(-1)
        gap = ((up.gather(1, ue) - up.gather(1, me)).abs()[diff]
               if diff.any() else torch.zeros(1))
        out[name] = dict(assignments=int(diff.sum()), tokens=int(sets.sum()),
                         prob_gap=float(gap.max()),
                         top1=int((ue[:, 0] != me[:, 0]).sum()))
    return out


def _named_detached(model) -> dict:
    return {n: p.detach() for n, p in model.named_parameters()}


def _sharded_bytes(tree_list, mesh):
    """(bytes at each position, the unique blocks' bytes, with replicas)."""
    from repro_torch.distributed import sharding as shr

    at = [0] * mesh.size
    unique = 0
    for tree in tree_list:
        leaves = []
        shr.tree_map(lambda x: leaves.append(x)
                     if isinstance(x, shr.Placed) else None, tree)
        for x in leaves:
            for i, b in enumerate(x.blocks):
                at[i] += b.nbytes
            unique += sum(b.nbytes for b in x.unique_blocks())
    return at, unique, sum(at)


@contextlib.contextmanager
def _attention_shapes():
    """Within: the (q, k) shapes of every ``flash_attention`` call the
    models' attention makes (``layers.blockwise_attention``), appended to
    the yielded list."""
    from repro_torch.models import layers

    seen = []
    orig = layers.flash_attention

    def recording(q, k, v, **kw):
        seen.append((tuple(q.shape), tuple(k.shape)))
        return orig(q, k, v, **kw)

    layers.flash_attention = recording
    try:
        yield seen
    finally:
        layers.flash_attention = orig


def _row_grads(model, batch, row_loss):
    """Each data row's (half the batch's) gradients of its own loss."""
    half = next(iter(batch.values())).shape[0] // 2
    rows = []
    for r in range(2):
        lo = row_loss(model, {k: v[r * half:(r + 1) * half]
                              for k, v in batch.items()})[0]
        gs = torch.autograd.grad(lo, list(model.parameters()),
                                 allow_unused=True)  # embed_head: unused
        rows.append({n: torch.zeros_like(p) if g is None else g
                     for (n, p), g in zip(model.named_parameters(), gs)})
        del lo, gs
    return rows


def _run_gaps(run, ref):
    """The gaps of one unsharded step's (loss, weights, state, gradient
    norm) from another's."""
    gaps = dict(loss=abs(run[0] - ref[0]), grad_norm=abs(run[3] - ref[3]),
                params=_max_gap(run[1], ref[1]))
    for f in ("master", "m", "v"):
        gaps[f] = _max_gap(getattr(run[2], f), getattr(ref[2], f))
    return gaps


def _f32_limits(what, gap, noise, top, keys):
    """f32 steps: each of ``keys`` within MESH_NOISE x its noise, or 1e-6
    of the loss / MESH_F32_FLOOR of the others' max."""
    for k in keys:
        floor = 1e-6 if k == "loss" else MESH_F32_FLOOR
        lim = max(MESH_NOISE * noise[k], floor * top[k])
        require(gap[k] <= lim, f"{what}: step 0's {k}: mesh vs unsharded "
                f"{gap[k]:.3e}, limit {lim:.3e} (noise {noise[k]:.3e})")


def _mesh_vs_unsharded(dev, what, cell, model, batch, mz, opt_cfg,
                       rehearse, cell32=None):
    """``cell`` (a train cell) on a (data 2, model 2) mesh of one device
    against its unsharded step on copies of ``model``, ``mz["steps"]``
    steps each: step 0's loss, gradient norm, weights, master copy and
    moments against the unsharded step's and its noise (that step with the
    batch's two halves in the other order); the blocks' shapes and bytes;
    step times, launches by route and the attention's shapes over the
    mesh's steps, counted from 0.

    Limits: the weights and master copy within MESH_NOISE x the noise (PR
    30's; with f32 weights plus two learning-rate steps: at step 1 AdamW
    moves each element by lr times its gradient's sign). With 16-bit
    weights the tensor-parallel products round in other places than the
    unsharded ones (other GEMM shapes), so first an f32 copy of the model
    runs one step on the mesh (``cell32``, the same cell of the f32
    config) against its own unsharded step at the f32 limits below, each
    of its moment tensors within MESH_F32_MOMENTS of its own max (a
    router whose layer the mesh routed otherwise, counted by
    :func:`_route_flips`, and the norm it reads, within
    MESH_F32_FLIPPED_ROUTER); then
    the 16-bit mesh step's loss and moments are held no
    further from that f32 step than MESH_NOISE x the unsharded 16-bit step
    is (the loss plus 1e-6 of it). With f32 weights the loss, the gradient
    norm and the moments within MESH_NOISE x the noise or the same
    floors. (out, step 0's metrics)."""
    import copy

    from repro_torch.configs import common
    from repro_torch.distributed import sharding as shr
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.optimizer import adamw_scalars, make_adamw

    mesh = make_mesh((2, 2), ("data", "model"), [dev] * 4)
    args = cell.abstract_args(mesh)
    opt_init = make_adamw(opt_cfg)[0]
    steps = mz["steps"]
    out = dict(mesh=str(mesh), steps=steps)
    half16 = any(p.dtype != torch.float32 for p in model.parameters())
    half = next(iter(batch.values())).shape[0] // 2
    swapped = {k: torch.cat([v[half:], v[:half]]) for k, v in batch.items()}

    def unsharded(b, n_steps, src=model):
        m = copy.deepcopy(src)
        o = opt_init(m)
        first, times, counts = None, [], []
        for i in range(n_steps):
            fa.reset_launches()
            t0 = time.perf_counter()
            m, o, met = cell.fn(m, o, b)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            counts.append(dict(fa.launches))
            if first is None:
                first = (float(met["loss"]), {n: t.clone() for n, t in
                                              _named_detached(m).items()}, o,
                         float(met["grad_norm"]))
        del m, o
        return first, times, counts

    ref, ref_times, ref_counts = unsharded(batch, steps)
    noise_run, _, _ = unsharded(swapped, 1)
    noise = _run_gaps(noise_run, ref)
    top = dict(loss=abs(ref[0]), grad_norm=ref[3], params=max(
        float(t.float().abs().max()) for t in ref[1].values()))
    for f in ("master", "m", "v"):
        top[f] = max(float(t.abs().max())
                     for t in getattr(ref[2], f).values())
    del noise_run
    if half16:
        # an f32 copy: its mesh step against its unsharded step at f32's
        # limits, then its unsharded step is the 16-bit steps' yardstick
        m32 = _cut_copy(model, model.cfg.n_layers, dev, dtype=torch.float32)
        with _recording_routes() as f32_routes:
            f32_run, _, _ = unsharded(batch, 1, src=m32)
        noise_f32 = _run_gaps(unsharded(swapped, 1, src=m32)[0], f32_run)
        args32 = cell32.abstract_args(mesh)
        routers = [n for n, _ in m32.named_parameters()
                   if n.endswith("moe.router")]
        with _recording_routes() as mesh_routes:
            pp32, po32, met32 = cell32.fn(
                *(shr.place(x, common.arg_shardings(a)) for x, a in zip(
                    (m32, opt_init(m32), batch), args32)))
        del m32
        flips = _route_flips(f32_routes, mesh_routes, routers, 2)
        del mesh_routes, f32_routes
        gap_f32 = dict(loss=abs(float(met32["loss"]) - f32_run[0]),
                       grad_norm=abs(float(met32["grad_norm"]) - f32_run[3]),
                       params=_max_gap(shr.gather(pp32), f32_run[1]))
        top_f32 = dict(loss=abs(f32_run[0]), grad_norm=f32_run[3],
                       params=max(float(t.abs().max())
                                  for t in f32_run[1].values()))
        for f in ("master", "m", "v"):
            gap_f32[f] = _max_gap(shr.gather(getattr(po32, f)),
                                  getattr(f32_run[2], f))
            top_f32[f] = max(float(t.abs().max())
                             for t in getattr(f32_run[2], f).values())
        shares = {f: _shares(shr.gather(getattr(po32, f)),
                             getattr(f32_run[2], f)) for f in ("m", "v")}
        del pp32, po32, met32
        out.update(f32_mesh_gap=gap_f32, f32_noise=noise_f32,
                   f32_max_abs=top_f32, f32_route_flips=flips,
                   f32_moment_shares={f: x[:6] for f, x in shares.items()})
        log(f"  {what} an f32 copy, its mesh step vs its unsharded step: "
            f"{json.dumps(gap_f32)}; noise {json.dumps(noise_f32)}; max |x| "
            f"{json.dumps(top_f32)}; each MoE layer's routing, the mesh's "
            f"assignments to another expert {json.dumps(flips)}; m's and "
            f"v's largest gaps of a tensor's own max (share, name, gap, its "
            f"max) {json.dumps(out['f32_moment_shares'])}")
        relaxed = {}
        for name, fl in flips.items():
            if fl["assignments"]:
                relaxed[name] = relaxed[name.replace("moe.router", "ln2")] = fl
        for f, rows in shares.items():
            for _, name, g, t_max in rows:
                k = (MESH_F32_FLIPPED_ROUTER if name in relaxed
                     else MESH_F32_MOMENTS)
                require(g <= k * t_max, f"{what} the f32 copy: step 0's {f} "
                        f"of {name}: mesh vs unsharded {g:.3e}, limit {k} x "
                        f"its max {t_max:.3e} (routing: {relaxed.get(name)})")
        _f32_limits(f"{what} the f32 copy", gap_f32, noise_f32, top_f32,
                    ("loss", "grad_norm", "params", "master"))
        f32 = dict(loss=f32_run[0], m=f32_run[2].m, v=f32_run[2].v)
        del f32_run
        dist = dict(loss=abs(ref[0] - f32["loss"]),
                    m=_max_gap(ref[2].m, f32["m"]),
                    v=_max_gap(ref[2].v, f32["v"]))

    # placed by abstract_args(mesh)'s shardings
    pp = shr.place(model, common.arg_shardings(args[0]))
    po = shr.place(opt_init(model), common.arg_shardings(args[1]))
    pb = shr.place(batch, common.arg_shardings(args[2]))
    blocks_ok = all(
        tuple(b.shape) == x.sharding.block_shape(x.shape)
        for tree in (pp, po.master, po.m, po.v) for x in tree.values()
        for b in x.blocks)
    require(blocks_ok, f"{what}: a block's shape is not its spec's")
    at, unique, with_replicas = _sharded_bytes([pp, po], mesh)
    whole = sum(p.nbytes for p in model.parameters()) + sum(
        t.nbytes for f in ("master", "m", "v")
        for t in getattr(ref[2], f).values())
    require(unique == whole, f"{what}: the blocks hold {unique:,} bytes, "
            f"the unsharded state {whole:,}")
    out.update(bytes_at_position=at, bytes_unique=unique,
               bytes_with_replicas=with_replicas, bytes_unsharded=whole)

    # the mesh's steps, launches counted from 0
    fa.reset_launches()
    losses, times = [], []
    with _attention_shapes() as shapes:
        for i in range(steps):
            t0 = time.perf_counter()
            pp, po, met = cell.fn(pp, po, pb)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(met["loss"]))
            if i == 0:
                met0 = {k: v for k, v in met.items()}
                gap = dict(loss=abs(losses[0] - ref[0]),
                           grad_norm=abs(float(met["grad_norm"]) - ref[3]),
                           params=_max_gap(shr.gather(pp), ref[1]))
                for f in ("master", "m", "v"):
                    gap[f] = _max_gap(shr.gather(getattr(po, f)),
                                      getattr(ref[2], f))
                if half16:
                    gap32 = dict(loss=abs(losses[0] - f32["loss"]),
                                 m=_max_gap(shr.gather(po.m), f32["m"]),
                                 v=_max_gap(shr.gather(po.v), f32["v"]))
    launches = dict(fa.launches)  # read just after the path
    lr1 = float(adamw_scalars(opt_cfg, 1, torch.tensor(1.0)).lr)
    out.update(losses=losses, ref_loss=ref[0], gap=gap, noise=noise,
               max_abs=top, step_ms=[1e3 * t for t in times],
               unsharded_step_ms=[1e3 * t for t in ref_times],
               launches=launches, unsharded_launches_per_step=ref_counts[-1],
               attention_shapes=sorted({str(x) for x in shapes}), lr_step1=lr1)
    log(f"  {what}: losses {json.dumps(losses)}; step 0 vs unsharded "
        f"{json.dumps(gap)}, noise {json.dumps(noise)}, max |x| "
        f"{json.dumps(top)}")
    for k in ("params", "master"):
        lim = MESH_NOISE * noise[k] + (0.0 if half16 else 2 * lr1)
        require(gap[k] <= lim, f"{what}: step 0's {k}: mesh vs unsharded "
                f"{gap[k]:.3e}, limit {lim:.3e} (noise {noise[k]:.3e})")
    if half16:
        out.update(f32_loss=f32["loss"], unsharded_from_f32=dist,
                   mesh_from_f32=gap32)
        log(f"      from the f32 copy's step: the mesh step "
            f"{json.dumps(gap32)}, the unsharded step {json.dumps(dist)}")
        for k in ("loss", "m", "v"):
            lim = MESH_NOISE * dist[k] + (1e-6 * top[k] if k == "loss"
                                          else 0.0)
            require(gap32[k] <= lim, f"{what}: step 0's {k} is {gap32[k]:.3e}"
                    f" from the f32 step's, limit {lim:.3e} (the unsharded "
                    f"step's {dist[k]:.3e})")
        del f32
    else:
        _f32_limits(what, gap, noise, top, ("loss", "grad_norm", "m", "v"))
    require(all(math.isfinite(x) for x in losses),
            f"{what}: a loss is not finite")
    if dev.type == "cuda":
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    log(f"      step ms {json.dumps([round(x, 3) for x in out['step_ms']])} "
        f"beside the unsharded "
        f"{json.dumps([round(x, 3) for x in out['unsharded_step_ms']])}; "
        f"launches {launches} (unsharded a step {ref_counts[-1]}); attention "
        f"shapes (q, k) {out['attention_shapes']}")
    log(f"      bytes at each position {at}; each element once {unique:,} "
        f"= unsharded {whole:,}; with replicas {with_replicas:,}; "
        f"max_memory_allocated {out.get('max_memory_allocated')}")
    del pp, po, pb, ref
    return out, met0


def _require_shard_launches(what, out, heads, rehearse):
    """The wgmma forward and backward launched R x M = 4 times the
    unsharded step's a step, on the route's counters only, and every
    attention call at a model shard's (B_row, H / 2, S, dh) query heads
    with k and v repeated to them."""
    if rehearse:
        return
    per, launches, steps = (out["unsharded_launches_per_step"],
                            out["launches"], out["steps"])
    for k in ("flash_attention_wgmma", "flash_attention_bwd_wgmma"):
        require(per[k] > 0 and launches[k] == 4 * per[k] * steps,
                f"{what}: {k}: {launches[k]} launches in {steps} steps, the "
                f"unsharded step {per[k]} a step")
    require(launches["flash_attention_simt"] == 0
            and launches["flash_attention_bwd"]
            == launches["flash_attention_bwd_wgmma"],
            f"{what}: a launch off the wgmma route: {launches}")
    require(out["attention_shapes"] == [str((heads, heads))],
            f"{what}: attention at {out['attention_shapes']}, a shard's "
            f"heads are {heads}")


def mesh_train(dev, mz, rehearse):
    """(a) qwen3-0.6b's train cell on a (data 2, model 2) mesh of one
    device: the tensor-parallel step against the unsharded step."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T
    from repro_torch.train.optimizer import AdamWConfig

    spec = get_arch(mz["arch"])
    cfg = spec.make_config(mz["smoke"])
    cell = spec.build_cell(cfg, "train_4k", smoke=mz["smoke"])
    cell32 = spec.build_cell(dataclasses.replace(cfg, dtype=torch.float32),
                             "train_4k", smoke=mz["smoke"])
    if dev.type == "cuda":
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    model = T.init_params(mz["seed"], cfg, device=dev)
    rng = np.random.default_rng(mz["seed"])
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (
        mz["batch"], mz["seq"] + 1)).astype(np.int32)).to(dev)
    batch = {"tokens": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous()}
    # each data row's step-0 gradients: (c)'s input
    rows = _row_grads(model, batch, T.loss_fn)
    out, _ = _mesh_vs_unsharded(dev, "(a)", cell, model, batch, mz,
                                AdamWConfig(), rehearse, cell32)
    out.update(arch=mz["arch"], layers=cfg.n_layers, batch=mz["batch"],
               seq=mz["seq"])
    if dev.type == "cuda":
        out["memory_allocated_at_start"] = start
    heads = (mz["batch"] // 2, cfg.n_heads // 2, mz["seq"], cfg.head_dim)
    _require_shard_launches("(a)", out, heads, rehearse)
    return out, model, rows


def mesh_moe(dev, mz, rehearse):
    """(d) granite-moe-3b-a800m at full width, depth cut to
    ``mz["moe"]["layers"]`` (its smoke config in a rehearsal), on the
    (2, 2) mesh against its unsharded step; the MoE's routing layout the
    global batch's (32 groups of 256 tokens at capacity 64 at full size),
    the aux loss and each layer's dropped assignments against the
    unsharded forward's."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T
    from repro_torch.train.optimizer import AdamWConfig

    mm = mz["moe"]
    spec = get_arch(mm["arch"])
    cfg = dataclasses.replace(spec.make_config(mz["smoke"]),
                              n_layers=mm["layers"])
    cell = spec.build_cell(cfg, "train_4k", smoke=mz["smoke"])
    cell32 = spec.build_cell(dataclasses.replace(cfg, dtype=torch.float32),
                             "train_4k", smoke=mz["smoke"])
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
    model = T.init_params(mz["seed"], cfg, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(mz["seed"] + 2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (
        mm["batch"], mm["seq"] + 1)).astype(np.int32)).to(dev)
    batch = {"tokens": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous()}
    mc = cfg.moe_cfg()
    n_tok = mm["batch"] * mm["seq"]
    g = MOE.n_groups(mc, n_tok)
    layout = dict(groups=g, group_tokens=n_tok // g,
                  capacity=MOE.capacity(mc, n_tok // g),
                  row_groups_capacity=MOE.row_layout(mc, n_tok, 2))
    if not mz["smoke"]:
        require((g, n_tok // g, layout["capacity"]) == (32, 256, 64)
                and layout["row_groups_capacity"] == (16, 64),
                f"(d) the routing layout {layout}")
    def forward_stats(m):
        with torch.no_grad(), _counting_drops() as counts:
            _, fwd = T.loss_fn(m, batch)
        return float(fwd["aux"]), [int(c) for c, _ in counts], counts[0][1]

    ref_aux, ref_drop, assignments = forward_stats(model)
    m32 = _cut_copy(model, cfg.n_layers, dev, dtype=torch.float32)
    aux32, drop32, _ = forward_stats(m32)
    del m32
    out, met0 = _mesh_vs_unsharded(dev, "(d)", cell, model, batch, mm,
                                   AdamWConfig(), rehearse, cell32)
    drop = [int(x) for x in met0["dropped"]]
    aux = float(met0["aux"])
    out.update(arch=mm["arch"], layers=cfg.n_layers, batch=mm["batch"],
               seq=mm["seq"], params=n_params, layout=layout, aux=aux,
               ref_aux=ref_aux, f32_aux=aux32, dropped=drop,
               ref_dropped=ref_drop, f32_dropped=drop32,
               assignments_a_layer=assignments,
               dropped_equal=drop == ref_drop)
    if dev.type == "cuda":
        out["memory_allocated_at_start"] = start
    log(f"      routing {json.dumps(layout)}; aux {aux!r} (the unsharded "
        f"forward's {ref_aux!r}, its f32 copy's {aux32!r}); dropped a layer "
        f"{drop} (unsharded {ref_drop}, f32 {drop32}) of {assignments}")
    # the aux as the losses: no further from the f32 copy's than MESH_NOISE
    # x the unsharded 16-bit forward is, plus MOE_LOSS_RTOL of it
    lim = MESH_NOISE * abs(ref_aux - aux32) + MOE_LOSS_RTOL * abs(aux32)
    require(abs(aux - aux32) <= lim, f"(d) aux {aux!r} is "
            f"{abs(aux - aux32):.3e} from the f32 copy's {aux32!r}, limit "
            f"{lim:.3e} (the unsharded forward's {ref_aux!r})")
    require(len(drop) == len(ref_drop) and all(
        abs(a - b) <= 1e-3 * assignments for a, b in zip(drop, ref_drop)),
        f"(d) dropped {drop} against the unsharded forward's {ref_drop}")
    heads = (mm["batch"] // 2, cfg.n_heads // 2, mm["seq"], cfg.head_dim)
    _require_shard_launches("(d)", out, heads, rehearse)
    del model, batch
    return out


def mesh_recsys(dev, mz, rehearse):
    """(e) BST's train_batch cell at full size (its smoke cell in a
    rehearsal) on the (2, 2) mesh against its unsharded step: each data
    row through a copy of the model ("model" shards the storage)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import recsys as R
    from repro_torch.train.optimizer import AdamWConfig

    rz = mz["recsys"]
    spec = get_arch(rz["arch"])
    cfg = spec.make_config(mz["smoke"])
    cell = spec.build_cell(cfg, "train_batch", smoke=mz["smoke"])
    b = cell.abstract_args()[2]["label"].shape[0]
    model = R.bst_init(torch.Generator(device=dev).manual_seed(mz["seed"]),
                       cfg)
    g = torch.Generator(device=dev).manual_seed(mz["seed"] + 3)
    batch = _rs_batch(rz["arch"], cfg, b, g, dev, min(rz["pool"], cfg.vocab))
    out, _ = _mesh_vs_unsharded(dev, "(e)", cell, model, batch, rz,
                                AdamWConfig(weight_decay=0.0), rehearse)
    out.update(arch=rz["arch"], batch=b)
    if not rehearse:
        require(out["launches"]["flash_attention_simt"] > 0
                and out["launches"]["flash_attention_bwd_simt"] > 0,
                f"(e) BST's attention did not launch: {out['launches']}")
    del model, batch
    return out


def mesh_attention_rows(dev, mz, rehearse):
    """The attention kernels at a model shard's heads of (a) and (d)
    (bf16, causal, k and v repeated to the shard's query heads as
    ``blockwise_attention`` copies them): the forward through
    :func:`attention_kernel_rows`; the backward (``wgmma``, given the
    forward's log-sum-exp) against its plain version within BWD_TOL, bit-
    equal twice, timed beside its bound, the plain version and SDPA's
    backward alone. (forward rows, backward rows)."""
    from repro_torch.kernels import flash_attention as fa

    fwd = attention_kernel_rows(dev, dict(attn=mz["attn"], decode=()),
                                rehearse)
    g = torch.Generator(device=dev).manual_seed(37)
    bwd = []
    for role, b, h, hkv, s, dh, dv in mz["attn"]:
        q, k, v = _attn_inputs(g, dev, b, h, s, s, dh, dv, BF16)
        dout = torch.randn(b, h, s, dv, generator=g, device=dev).to(BF16)
        with torch.inference_mode():
            o, lse = fa.flash_attention_lse(q, k, v, causal=True)
        before = fa.launches["flash_attention_bwd_wgmma"]
        got = fa.flash_attention_bwd(q, k, v, o, dout, causal=True, lse=lse)
        want = fa.flash_attention_bwd_plain(q, k, v, o, dout, causal=True)
        require(rehearse or fa.launches["flash_attention_bwd_wgmma"]
                == before + 1, f"{role}: the wgmma backward not launched")
        err = 0.0
        for x, w, name in zip(got, want, ("dq", "dk", "dv")):
            e = float((x.float() - w.float()).abs().max())
            require(e <= BWD_TOL[BF16] * float(w.float().abs().max()),
                    f"{role}: {name} max err {e:.3e}")
            err = max(err, e)
        again = fa.flash_attention_bwd(q, k, v, o, dout, causal=True, lse=lse)
        require(all(torch.equal(x, y) for x, y in zip(got, again)),
                f"{role}: two backward calls differ")
        pairs = b * h * _valid_pairs(s, s, True)
        nbytes = 2 * (2 * (q.numel() + k.numel() + v.numel())
                      + 2 * o.numel())
        row = dict(kernel="flash_attention_bwd", role=role, route="wgmma",
                   B=b, H=h, Hkv=hkv, S=s, dh=dh, dv=dv, dtype="bfloat16",
                   causal=True, max_abs_err=err)
        row["bound_ms"], row["bound_by"] = _bwd_bound("wgmma", BF16, nbytes,
                                                      pairs, dh, dv)
        if not rehearse:
            def run():
                return fa._backward_card(q, k, v, o, dout, True, dh ** -0.5,
                                         lse, None)

            row["ms"] = time_ms(run)
            row["device_ms"] = time_graph_ms(run)
            row["plain_ms"] = time_ms(lambda: fa.flash_attention_bwd_plain(
                q, k, v, o, dout, causal=True), reps=3, inner=1)
            lib = _sdpa_backward(q, k, v, dout, True)
            row.update({k_: lib[k_] for k_ in ("library_ms", "library_backend",
                                               "library_device_ms")
                        if k_ in lib})
        bwd.append(row)
        log("  " + json.dumps(row))
        del q, k, v, o, lse, dout, got, want, again
    return fwd, bwd


def mesh_gpipe(dev, mz, model, rehearse):
    """(b) GPipe over the model's blocks."""
    from torch import nn

    from repro_torch.distributed.pipeline import gpipe_apply
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.mesh import make_mesh

    cfg = model.cfg
    n_st, n_micro, seq = mz["stages"], mz["n_micro"], mz["seq"]
    per = cfg.n_layers // n_st
    require(per * n_st == cfg.n_layers, f"(b) {cfg.n_layers} layers in "
            f"{n_st} stages")
    stages = [nn.ModuleList(model.blocks[s * per:(s + 1) * per])
              for s in range(n_st)]
    mesh = make_mesh((n_st,), ("pod",), [dev] * n_st)
    rng = np.random.default_rng(mz["seed"] + 1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (n_micro, 1, seq))
                            .astype(np.int32)).to(dev)
    with torch.no_grad():
        xm = model.embed_tokens(toks)  # (n_micro, 1, seq, d)
    params = [p for st in stages for p in st.parameters()]

    def stage_fn(blocks, x):
        pos = torch.arange(x.shape[1], device=x.device)
        for blk in blocks:
            x = blk(x, pos)[0]
        return x

    def loop(order):
        ys = [None] * n_micro
        for i in order:
            ys[i] = stage_fn(model.blocks, xm[i])
        return torch.stack(ys)

    def run(fn):
        fa.reset_launches()
        t0 = time.perf_counter()
        y = fn()
        loss = (y.float() ** 2).mean()
        g = torch.autograd.grad(loss, params)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return (y.detach(), g, time.perf_counter() - t0, dict(fa.launches))

    # the noise run first: it also warms the kernels for the two timed runs
    _, ng, _, _ = run(lambda: loop(reversed(range(n_micro))))
    piped, pg, pt, launches = run(lambda: gpipe_apply(
        stage_fn, stages, xm, mesh=mesh, n_micro=n_micro, remat=True)[0])
    looped, lg, lt, loop_launches = run(lambda: loop(range(n_micro)))
    require(torch.equal(piped, looped), "(b) GPipe's outputs differ from "
            "the per-microbatch loop's")
    gap = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(pg, lg))
    noise = max(float((a.float() - b.float()).abs().max())
                for a, b in zip(ng, lg))
    require(gap <= MESH_NOISE * noise, f"(b) GPipe's gradients {gap:.3e} "
            f"from the loop's, f32 noise {noise:.3e}")
    if not rehearse:
        want = dict(flash_attention_wgmma=2 * cfg.n_layers * n_micro,
                    flash_attention_bwd_wgmma=cfg.n_layers * n_micro)
        for k, n in want.items():
            require(launches[k] == n, f"(b) {k}: {launches[k]} launches, "
                    f"want {n} (the forward twice: remat)")
    out = dict(stages=n_st, blocks_a_stage=per, n_micro=n_micro, seq=seq,
               gpipe_ms=1e3 * pt, loop_ms=1e3 * lt, grad_gap=gap,
               grad_noise=noise, launches=launches,
               loop_launches=loop_launches)
    log(f"  (b) GPipe {n_st} stages of {per} blocks, {n_micro} microbatches "
        f"of 1 x {seq}: outputs bit-equal to the loop; gradients "
        f"{gap:.3e} from it (noise {noise:.3e}); {out['gpipe_ms']:.3f} ms "
        f"beside the loop's {out['loop_ms']:.3f} ms (forward and "
        f"backward); launches {launches}")
    del stages, xm, pg, lg, ng
    return out


def mesh_qpsum(dev, model, rows):
    """(c) the int8 all-reduce over the two data shards' gradients."""
    from repro_torch.train.compression import QBLOCK, quantized_psum

    out_trees = quantized_psum(rows)
    worst = top = 0.0
    s = len(rows)
    for name in rows[0]:
        exact = sum(r[name].float() for r in rows)
        d = exact.shape[-1]
        pad = (-d) % QBLOCK
        scale = torch.stack([
            torch.nn.functional.pad(r[name].float(), (0, pad)).reshape(
                *exact.shape[:-1], -1, QBLOCK).abs().amax(-1) / 127.0
            for r in rows]).amax(0)
        per = scale.repeat_interleave(QBLOCK, -1)[..., :d]
        # the quantization's bound, plus the bf16 rounding of the output
        lim = s * per / 2 * (1 + 2.0 ** -8) + exact.abs() * 2.0 ** -8
        err = (out_trees[0][name].float() - exact).abs()
        require(bool((err <= lim).all()), f"(c) {name}: an element past its "
                f"bound by {float((err - lim).max()):.3e}")
        worst = max(worst, float(err.max()))
        top = max(top, float(exact.abs().max()))
        require(all(torch.equal(o[name], out_trees[0][name])
                    for o in out_trees), f"(c) {name}: the shards differ")
    names = ["embed"] + [n for n in rows[0] if n.startswith("blocks.0.")]
    cpu = quantized_psum([{n: r[n].cpu() for n in names} for r in rows])
    for n in names:
        require(torch.equal(cpu[0][n], out_trees[0][n].cpu()),
                f"(c) {n}: the card's sum differs from the CPU's")
    out = dict(rel_err=worst / top, max_abs_err=worst, leaves=len(rows[0]),
               cpu_equal=names)
    log(f"  (c) quantized_psum over {s} shards, {len(rows[0])} leaves: "
        f"every element within S·scale/2; relative error {worst / top:.4e} "
        f"(max |err| / max |sum|); card = CPU on {len(names)} leaves")
    return out


def mesh_slice(dev, mz, rehearse):
    """Phase 18 at ``mz`` (:func:`mesh_sizes`)."""
    import gc

    def free():
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    free()
    out = {}
    out["train"], model, rows = mesh_train(dev, mz, rehearse)
    out["gpipe"] = mesh_gpipe(dev, mz, model, rehearse)
    out["qpsum"] = mesh_qpsum(dev, model, rows)
    del model, rows
    free()
    out["moe"] = mesh_moe(dev, mz, rehearse)
    free()
    out["recsys"] = mesh_recsys(dev, mz, rehearse)
    free()
    out["attention"], out["attention_bwd"] = mesh_attention_rows(
        dev, mz, rehearse)
    free()
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
    import dataclasses

    from repro_torch.configs import (deepseek_v3_671b, granite_moe_3b_a800m,
                                     qwen3_0_6b)
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
                     decode=(("decode, toy", 2, 2, 2, 128, 16, BF16, None),
                             ("decode, toy, full cache", 1, 2, 2, 128, 16,
                              BF16, "full"),
                             ("decode, toy, GQA", 3, 4, 2, 128, 16, BF16,
                              (1, 128, 40)),
                             ("decode, toy, MQA", 3, 4, 1, 128, 16, BF16,
                              (1, 128, 40)),
                             ("decode, toy, GQA f32", 3, 4, 2, 128, 16, F32,
                              (1, 128, 40))),
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
                                temperature=0.2),
                     lm=dict(cfg=qwen3_0_6b.smoke, seed=0, batch=2,
                             prompt=24, max_seq=32, cut_layers=1,
                             cross=dict(batch=2, prompt=8, steps=3),
                             train=dict(arch="qwen3-0.6b", preset="smoke",
                                        batch=2, seq=16, steps=12)),
                     biencoder=dict(scale="smoke", stop=2, steps=4),
                     recsys=dict(cfg="smoke", seed=0, serve=(16, 64),
                                 serve_reps=1, n_cand=256, retrieve_reps=1,
                                 check_cands=64, din_cand_chunk=100,
                                 xdfm_cand_chunk=64, xdfm_serve_chunk=32,
                                 train=dict(bst=32, din=32, bert4rec=32,
                                            xdeepfm=32),
                                 b4r_chunk=8, steps=10, lr=1e-3, warmup=2,
                                 pool=64, cross_rows=128, cross_batch=16,
                                 attn=(("bst serve_p99, toy", 4, 8, 21, 4,
                                        "simt"),
                                       ("bert4rec, toy", 2, 2, 40, 32,
                                        "tf32"))),
                     moe=dict(granite=dict(cfg=granite_moe_3b_a800m.smoke,
                                           seed=0, batch=2, prompt=24,
                                           max_seq=32, steps=4),
                              dsv3=dict(cfg=deepseek_v3_671b.smoke, seed=0,
                                        batch=2, prompt=24, max_seq=32,
                                        steps=4),
                              cross=dict(cut_layers=1, batch=2, seq=16,
                                         decode_prompt=12, decode_steps=2,
                                         layer_seq=16, experts=4,
                                         tokens=(31, 64)),
                              train=dict(seed=0, batch=2, seq=32, ce_chunk=16,
                                         steps=3, launch_batch=2,
                                         launch_seq=16),
                              attn=(("MLA, toy", 1, 4, 4, 64, 24, 16),
                                    ("GQA, toy", 1, 6, 2, 64, 16, 16)),
                              decode=(("GQA decode, toy", 2, 6, 2, 128,
                                       16),)),
                     dense=dense_lm_sizes(True))
    else:
        # timing shapes: build wave (B=1024), stage-1 wave, stage-2 wave,
        # stage-2 entry wave (K = Q/2 seeds), re-rank scoring wave (K = Q)
        sizes = dict(n=args.n, dims=(384, 4096), ks=(64, 500, 1000), b=256,
                     timing={384: ((1024, 64), (256, 64)),
                             4096: ((256, 64), (256, 500), (256, 1000))},
                     local_timing={384: ((256, 64),), 4096: ((256, 64),)},
                     shapes=((1024, 256, 64), (256, 500, 64), (256, 1000, 64),
                             (256, 1000, 500)), cn=8192, cd=384, cD=4096,
                     cq=16,
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
                     # then qwen3-0.6b's grouped cache (16 query heads
                     # over 8 kv heads) at the same cut, with lengths 1, S
                     # and one inside a split, also as MQA and in f32
                     decode=(("sfr-mistral-7b at decode_32k, B 128 cut to 8",
                              8, 32, 32, 32768, 128, BF16, None),
                             ("sfr-mistral-7b at decode_32k, B=1, full cache",
                              1, 32, 32, 32768, 128, BF16, "full"),
                             ("qwen3-0.6b at decode_32k, B 128 cut to 8, GQA "
                              "16 over 8", 8, 16, 8, 32768, 128, BF16,
                              (1, 32768, 1500)),
                             ("qwen3-0.6b at decode_32k, MQA edge (1 kv head)",
                              8, 16, 1, 32768, 128, BF16, (1, 32768, 1500)),
                             ("qwen3-0.6b at decode_32k, GQA in f32", 8, 16,
                              8, 32768, 128, F32, (1, 32768, 1500))),
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
                                temperature=0.2),
                     # phase 12: qwen3-0.6b at full width from a seed;
                     # decode_32k with batch 128 cut to 8 (as phase 6):
                     # prompts of 32,704 tokens and 64 greedy steps fill a
                     # 32,768 cache; the card-vs-CPU check cut to 2 layers;
                     # train_4k with batch 256 cut to 2 at seq 4,096 (two
                     # cross-entropy chunks), 12 steps, resumed from the
                     # launcher's async checkpoint at 10
                     lm=dict(cfg=qwen3_0_6b.full, seed=0, batch=8,
                             prompt=32704, max_seq=32768, cut_layers=2,
                             cross=dict(batch=2, prompt=64, steps=4),
                             train=dict(arch="qwen3-0.6b", preset="full",
                                        batch=2, seq=4096, steps=12)),
                     # phase 13: examples/train_biencoder.py's pipeline at
                     # --scale 100m, 10 steps, then resumed to 20
                     biencoder=dict(scale="100m", stop=10, steps=20),
                     # phase 14: the recommenders' full configs from a seed;
                     # serve_p99 and serve_bulk, retrieval_cand (DIN over
                     # candidate chunks of 131,072, xDeepFM's scan at
                     # 40,000), train_batch (BERT4Rec cut to 8,192 in loss
                     # chunks of 512, xDeepFM to 16,384), 10 steps on ids
                     # from the first 4,096 rows; card vs CPU on 64 rows
                     # with the tables cut to 65,536 rows
                     recsys=dict(cfg="full", seed=0, serve=(512, 262144),
                                 serve_reps=3, n_cand=1_000_000,
                                 retrieve_reps=2, check_cands=4096,
                                 din_cand_chunk=131072,
                                 xdfm_cand_chunk=40000,
                                 xdfm_serve_chunk=32768,
                                 train=dict(bst=65536, din=65536,
                                            bert4rec=8192, xdeepfm=16384),
                                 b4r_chunk=512, steps=10, lr=1e-3, warmup=2,
                                 pool=4096, cross_rows=65536, cross_batch=64,
                                 attn=(("bst serve_p99", 512, 8, 21, 4,
                                        "simt"),
                                       ("bert4rec", 64, 2, 200, 32,
                                        "tf32"))),
                     # phase 15: granite-moe-3b-a800m at full size, 8
                     # prompts of 2,048 into a 4,096 cache, 64 steps;
                     # deepseek-v3-671b at its full widths cut to 4 layers
                     # (its 3 dense, one MoE of 256 experts; the MTP head),
                     # 8 prompts of 1,024, 32 steps; card vs CPU: granite
                     # cut to 2 layers at (2, 128), DS-V3's first layer at
                     # (1, 256) and its MoE cut to 16 experts (1.4 GB on
                     # the CPU) at T=31 and 64; the smoke configs' loss
                     # and gradients, 6 launcher steps; the kernels at
                     # DS-V3's MLA and granite's prefill layer, granite's
                     # decode
                     moe=dict(granite=dict(cfg=granite_moe_3b_a800m.full,
                                           seed=0, batch=8, prompt=2048,
                                           max_seq=4096, steps=64),
                              dsv3=dict(cfg=lambda: dataclasses.replace(
                                  deepseek_v3_671b.full(), n_layers=4),
                                        seed=0, batch=8, prompt=1024,
                                        max_seq=4096, steps=32),
                              cross=dict(cut_layers=2, batch=2, seq=128,
                                         decode_prompt=96, decode_steps=4,
                                         layer_seq=256, experts=16,
                                         tokens=(31, 64)),
                              train=dict(seed=0, batch=2, seq=32, ce_chunk=16,
                                         steps=6, launch_batch=8,
                                         launch_seq=32),
                              attn=(("deepseek-v3-671b MLA prefill layer",
                                     8, 128, 128, 1024, 192, 128),
                                    ("granite-moe-3b-a800m prefill layer, "
                                     "24 over 8", 8, 24, 8, 2048, 64, 64)),
                              decode=(("granite-moe-3b-a800m decode, 24 over "
                                       "8, cache 4,096", 8, 24, 8, 4096,
                                       64),)),
                     # phase 17: granite-20b and deepseek-coder-33b at full
                     # depth, bf16 (dense_lm_sizes)
                     dense=dense_lm_sizes(False))

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

    t0 = time.perf_counter()
    log("phase 12: the LM path, qwen3-0.6b (prefill -> decode_step -> "
        "flash_decode on the grouped cache; loss_fn under the Trainer, "
        "checkpointed and resumed)")
    lm = lm_slice(dev, sizes, rehearse)
    report["lm"] = lm
    report["phase12_s"] = time.perf_counter() - t0
    log(f"  phase 12 took {report['phase12_s']:.1f} s")

    t0 = time.perf_counter()
    log("phase 13: launch/train_biencoder (train d with a resume, embed, "
        "build on d, search under the teacher)")
    be = biencoder_slice(dev, sizes, rehearse)
    report["biencoder"] = be
    report["phase13_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    log("phase 14: the recommender models (BST, DIN, BERT4Rec, xDeepFM: "
        "serving, retrieval, Trainer steps through the attention kernels; "
        "card vs CPU; the attention kernels at their shapes)")
    rs = recsys_slice(dev, sizes, rehearse)
    report["recsys"] = rs
    report["phase14_s"] = time.perf_counter() - t0
    log(f"  phase 14 took {report['phase14_s']:.1f} s")

    t0 = time.perf_counter()
    log("phase 15: MoE, MLA and MTP (granite-moe-3b-a800m full; "
        "deepseek-v3-671b at full widths, 4 layers: prefill -> decode_step; "
        "card vs CPU; loss and gradients; the kernels at their shapes)")
    mo = moe_slice(dev, sizes, rehearse)
    report["moe"] = mo
    report["phase15_s"] = time.perf_counter() - t0
    log(f"  phase 15 took {report['phase15_s']:.1f} s")

    t0 = time.perf_counter()
    log("phase 16: the GAT graph model (gat-cora at its four shapes: the "
        "forward at full size, card vs CPU, Trainer steps; the GNN "
        "corpus-search twin at ogbn-arxiv's size)")
    gn = gnn_slice(dev, gnn_sizes(rehearse), rehearse)
    report["gnn"] = gn
    report["phase16_s"] = time.perf_counter() - t0
    log(f"  phase 16 took {report['phase16_s']:.1f} s")

    t0 = time.perf_counter()
    log("phase 17: the dense LMs of the registry (granite-20b, MQA 48 over "
        "1; deepseek-coder-33b, 56 over 8) at full depth through their "
        "cells: prefill -> decode_step, embed_pool, decode_32k; card vs CPU; "
        "the kernels at their shapes")
    dn = dense_lm_slice(dev, sizes["dense"], rehearse)
    report["dense"] = dn
    report["phase17_s"] = time.perf_counter() - t0
    log(f"  phase 17 took {report['phase17_s']:.1f} s")

    t0 = time.perf_counter()
    log("phase 18: training on a mesh (qwen3-0.6b's train cell on a (data "
        "2, model 2) mesh of one card, tensor-parallel; GPipe over its "
        "blocks; the int8 all-reduce; granite-moe-3b-a800m at full width, 4 "
        "layers, routed over the global batch; BST's train cell; the "
        "attention kernels at a model shard's heads)")
    ms = mesh_slice(dev, mesh_sizes(rehearse), rehearse)
    report["mesh"] = ms
    report["phase18_s"] = time.perf_counter() - t0
    log(f"  phase 18 took {report['phase18_s']:.1f} s")

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
             launches_biencoder=be["launches"]["gather_score"],
             launches_gnn_search=gn["search"]["launches"]["gather_score"],
             max_abs_err=max(g_err, ct["wave_check"]["gather_max_abs_err"],
                             *(w["gather_max_abs_err"]
                               for w in tw["wave_checks"] + sv["wave_check"]
                               + gn["search"]["wave_checks"])),
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
             launches_biencoder=be["launches"]["beam_merge_topk"],
             launches_gnn_search=gn["search"]["launches"]["beam_merge_topk"],
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
        if name == "flash_attention":  # phases 8 and 14
            errs += [r["max_abs_err"] for r in tw["attention"]]
            errs += [r["fwd_max_abs_err"] for r in rs["attention"]]
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
            # phase 12: the prompts' prefill and the LM's training forward
            extra["launches_lm_prefill"] = sum(
                lm["decode"]["prefill_launches"][k]
                for k in ("flash_attention_simt", "flash_attention_wgmma"))
            extra["launches_lm_train"] = sum(
                lm["train"]["launches"][k]
                for k in ("flash_attention_simt", "flash_attention_wgmma"))
            # phase 14: the recommenders' serving, retrieval and training
            extra["launches_recsys"] = sum(
                rs["launches"][k]
                for k in ("flash_attention_simt", "flash_attention_wgmma"))
            extra["recsys_shapes"] = [
                {k: r.get(k) for k in ("role", "B", "H", "S", "dh", "ms",
                                       "device_ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms",
                                       "fwd_max_abs_err")}
                for r in rs["attention"]]
            # phase 15: granite's and DS-V3's prefill
            extra["launches_moe_prefill"] = {
                k: mo[k]["prefill_launches"].get("flash_attention_wgmma", 0)
                for k in ("granite", "dsv3")}
            # phase 17(a): the dense LMs' prefill and embed_pool
            extra["launches_dense_prefill"] = {
                k: dn[k]["prefill_launches"].get("flash_attention_wgmma", 0)
                for k in DENSE_ARCHS}
            extra["launches_dense_embed"] = {
                k: dn[k]["embed_launches"].get("flash_attention_wgmma", 0)
                for k in DENSE_ARCHS}
            # phase 18: the train cell on a mesh (3 steps) and GPipe
            extra["launches_mesh_train"] = ms["train"]["launches"][
                "flash_attention_wgmma"]
            extra["launches_gpipe"] = ms["gpipe"]["launches"][
                "flash_attention_wgmma"]
            # phase 18(d), (e): granite-moe's mesh steps, BST's
            extra["launches_mesh_moe_train"] = ms["moe"]["launches"][
                "flash_attention_wgmma"]
            extra["launches_mesh_recsys_train"] = ms["recsys"]["launches"][
                "flash_attention_simt"]
            errs += [r["max_abs_err"] for r in ms["attention"]]
            extra["mesh_shapes"] = [
                {k: r.get(k) for k in ("role", "B", "H", "Hkv", "S", "dh",
                                       "dv", "ms", "device_ms", "plain_ms",
                                       "bound_ms", "bound_by", "library_ms",
                                       "library_backend", "max_abs_err")}
                for r in ms["attention"]]
        if name == "flash_decode":  # phase 12(a): decode_step, on its path
            extra["launches_lm_decode"] = lm["decode"]["launches"][name]
            # phase 15(a): granite's decode (DS-V3's MLA decode runs none)
            extra["launches_moe_decode"] = {
                k: mo[k]["decode_launches"].get(name, 0)
                for k in ("granite", "dsv3")}
            # phase 17(a), (b): the dense LMs' decode, at 4,160 and 32k
            extra["launches_dense_decode"] = {
                k: dn[k]["decode_launches"].get(name, 0)
                for k in DENSE_ARCHS}
            extra["launches_dense_decode_32k"] = {
                k: dn[k]["decode_32k"]["launches"].get(name, 0)
                for k in DENSE_ARCHS}
        if name in ("flash_attention", "flash_decode"):  # phases 15(e), 17(d)
            for key, rows in (("moe_shapes", mo["attention"]),
                              ("dense_shapes", dn["attention"])):
                rows = [r for r in rows if r["kernel"] == name]
                errs += [r["max_abs_err"] for r in rows]
                extra[key] = [
                    {k: r.get(k) for k in ("role", "B", "H", "Hkv", "S", "dh",
                                           "dv", "ms", "device_ms", "plain_ms",
                                           "bound_ms", "bound_by",
                                           "library_ms", "library_backend",
                                           "max_abs_err")}
                    for r in rows]
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
        launches=tn["launches"]["flash_attention_bwd"],
        max_abs_err=max(bwd_err, *(r["bwd_max_abs_err"]
                                   for r in rs["attention"]),
                        *(r["max_abs_err"] for r in ms["attention_bwd"])),
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
        launches_lm_train_by_route={
            r: lm["train"]["launches"][f"flash_attention_bwd_{r}"]
            for r in ("wgmma", "tf32", "simt")},
        launches_recsys_by_route={
            r: rs["launches"][f"flash_attention_bwd_{r}"]
            for r in ("wgmma", "tf32", "simt")},
        launches_mesh_train_by_route={
            r: ms["train"]["launches"][f"flash_attention_bwd_{r}"]
            for r in ("wgmma", "tf32", "simt")},
        launches_gpipe_by_route={
            r: ms["gpipe"]["launches"][f"flash_attention_bwd_{r}"]
            for r in ("wgmma", "tf32", "simt")},
        launches_mesh_moe_train_by_route={
            r: ms["moe"]["launches"][f"flash_attention_bwd_{r}"]
            for r in ("wgmma", "tf32", "simt")},
        launches_mesh_recsys_train_by_route={
            r: ms["recsys"]["launches"][f"flash_attention_bwd_{r}"]
            for r in ("wgmma", "tf32", "simt")},
        mesh_shapes=[
            {k: r.get(k) for k in ("role", "B", "H", "Hkv", "S", "dh", "dv",
                                   "route", "ms", "device_ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms",
                                   "library_backend", "library_device_ms",
                                   "max_abs_err")}
            for r in ms["attention_bwd"]],
        recsys_shapes=[
            {k: r.get(k) for k in ("role", "B", "H", "S", "dh", "route",
                                   "bwd_ms", "bwd_device_ms", "bwd_plain_ms",
                                   "bwd_bound_ms", "bwd_bound_by",
                                   "bwd_library_ms", "bwd_library_device_ms",
                                   "bwd_max_abs_err")}
            for r in rs["attention"]],
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
