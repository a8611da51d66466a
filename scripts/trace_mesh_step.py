#!/usr/bin/env python3
"""Where the time of ``chip_smoke.py`` phase 18(a)'s tensor-parallel step
goes.

    python3 scripts/trace_mesh_step.py [--layers N] [--out FILE]

Draws qwen3-0.6b at full width (28 layers unless ``--layers``) from phase
18(a)'s seed, its train_4k cell at batch 2 x 4,096, and places it on a
(data 2, model 2) mesh of ``["cuda:0"] * 4``. Two steps warm each of the
mesh step and the unsharded step on a copy; then one step of each runs
under ``torch.profiler``. For each it prints the wall time, the device's
busy time and idle share, the kernels that took longest, the host ops
and kernel launches the step issued, and the host and device time spent
inside named parts of the step: the forward (``tensor_parallel.lm_loss``),
the forward and backward (``lm_loss_and_grads``), the weight gathers
(``Shards.tensor`` / ``Shards.whole``, again under remat), the attention
(within it the ``flash_attention`` call), FFN and cross entropy, the
column- and row-parallel products, the gradients' layout
(``Shards.grads``) and AdamW (``adamw_leaf``, a block at a time). The parts nest, so their times
overlap. One JSON line with the card's name and
power limit, also written to ``--out``. Needs one CUDA device; imports no
JAX.
"""
from __future__ import annotations

import argparse
import copy
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SEED, BATCH, SEQ = 0, 2, 4096  # phase 18(a)


def _ranged(owner, attr, label):
    """Wrap ``owner.attr`` in a profiler range named ``label``."""
    import torch

    fn = getattr(owner, attr)

    @functools.wraps(fn)
    def wrapped(*a, **kw):
        with torch.profiler.record_function(label):
            return fn(*a, **kw)

    setattr(owner, attr, wrapped)


def _step_profile(step):
    """One ``step()`` under ``torch.profiler``: wall ms, the kernels' device
    ms summed (busy) and the idle share of the wall time, the 15 longest
    kernels, the host ops and kernel launches, the named parts' host ms
    and the device ms of the kernels launched from their thread (the
    backward's run on autograd's own)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = 0.0
    ops = launches = 0
    parts, top, kernels = {}, [], []
    for ev in prof.key_averages():
        if ev.key.startswith("part:") and (
                ev.device_type == torch.autograd.DeviceType.CUDA):
            continue  # a range's span on the device timeline, no kernel
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(ev, "self_device_time_total", 0.0)
            busy += us / 1e3
            kernels.append((us / 1e3, ev.count, ev.key[:100]))
            continue
        if ev.key.startswith("part:"):
            parts[ev.key[5:]] = dict(
                host_ms=ev.cpu_time_total / 1e3,
                device_ms=getattr(ev, "device_time_total", 0.0) / 1e3,
                calls=ev.count)
        elif ev.key.startswith("aten::"):
            ops += ev.count
            top.append((ev.self_cpu_time_total / 1e3, ev.count, ev.key))
        elif ev.key in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                        "cuLaunchKernel", "cuLaunchKernelEx"):
            launches += ev.count
    return dict(wall_ms=wall * 1e3, device_busy_ms=busy,
                idle_share=1 - busy / (wall * 1e3) if busy else None,
                aten_ops=ops, kernel_launches=launches, parts=parts,
                top_self_host_ms=sorted(top, reverse=True)[:12],
                top_kernels_ms=sorted(kernels, reverse=True)[:15])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=28)
    ap.add_argument("--out", default="chiprun_out/trace_mesh_step.json")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src")]
    import dataclasses

    import torch

    if not torch.cuda.is_available():
        print("trace_mesh_step: no CUDA device is visible", file=sys.stderr)
        return 2
    from repro_torch.configs import common, get_arch
    from repro_torch.distributed import sharding as shr
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T
    from repro_torch.train.optimizer import AdamWConfig, make_adamw

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    for owner, attr, label in (
            (tp, "lm_loss", "forward"),
            (tp, "lm_loss_and_grads", "forward+backward"),
            (tp.Shards, "tensor", "gather a shard's block"),
            (tp.Shards, "whole", "gather a whole tensor"),
            (tp, "attention", "attention"), (tp, "ffn", "ffn"),
            (tp.layers, "blockwise_attention", "flash attention"),
            (tp, "column", "column-parallel products"),
            (tp, "row", "row-parallel products"),
            (tp, "cross_entropy", "cross entropy"),
            (tp.Shards, "grads", "gradients to the blocks' layout"),
            (common, "adamw_leaf", "adamw a block")):
        _ranged(owner, attr, "part:" + label)

    dev = torch.device("cuda")
    spec = get_arch("qwen3-0.6b")
    cfg = dataclasses.replace(spec.make_config(False), n_layers=args.layers)
    cell = spec.build_cell(cfg, "train_4k")
    model = T.init_params(SEED, cfg, device=dev)
    toks = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab, (BATCH, SEQ + 1)).astype(np.int32)).to(dev)
    batch = {"tokens": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous()}
    opt_init = make_adamw(AdamWConfig())[0]
    mesh = make_mesh((2, 2), ("data", "model"), [dev] * 4)
    placed = [shr.place(x, common.arg_shardings(a)) for x, a in zip(
        (model, opt_init(model), batch), cell.abstract_args(mesh))]
    state = {"mesh": placed[:2], "unsharded": None}
    m = copy.deepcopy(model)
    state["unsharded"] = [m, opt_init(m)]
    del model

    def run(which):
        p, o = state[which]
        b = placed[2] if which == "mesh" else batch
        p, o, _ = cell.fn(p, o, b)
        state[which] = [p, o]

    out = dict(card=card, arch="qwen3-0.6b", layers=cfg.n_layers,
               batch=BATCH, seq=SEQ, mesh=str(mesh))
    for which in ("mesh", "unsharded"):
        times = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(which)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[which] = dict(warm_step_ms=times,
                          **_step_profile(functools.partial(run, which)))
    line = json.dumps(out)
    print(line, flush=True)
    path = ROOT / args.out
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
