#!/usr/bin/env python3
"""Time ``ops.embedding_bag`` at DIN's shapes, for an A/B of two checkouts.

    python3 scripts/time_bag.py [--src DIR] [--rows V [V ...]]

Imports ``repro_torch`` from DIR (default: this checkout's ``src``), builds
its kernels into that checkout's ``build/``, and prints one JSON line per
(table rows, batch, mode) of ``chip_smoke.py`` phase 6's bag (DIN: D = 18
f32, L = 100, lengths in [0, 100]; B = 65,536 and 512): the eager ``ms``
(CUDA events around back-to-back calls) and the ``device_ms`` (CUDA-graph
replay), with the card's name and power limit. DIN's table has V = 2^20
rows (75.5 MB, more than the 50 MB L2); smaller ``--rows`` show the same
bags with the table held in L2. Run it for each checkout in turns in one
call (parent, change, change, parent). Needs one CUDA device; imports no
JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src/ directory whose repro_torch is timed")
    ap.add_argument("--rows", type=int, nargs="+", default=[1 << 20],
                    help="table rows V (DIN: 2^20)")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke  # its timers and ids; it imports no repro_torch yet
    import torch

    if not torch.cuda.is_available():
        print("time_bag: no CUDA device is visible", file=sys.stderr)
        return 2
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    from repro_torch.kernels import ops

    import repro_torch
    chip_smoke.require(Path(repro_torch.__file__).is_relative_to(src),
                       f"repro_torch imported from {repro_torch.__file__}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(17)
    for v in args.rows:
        table = torch.randn(v, 18, generator=g, device=dev)
        for role, b in (("din train_batch", 65536), ("din serve_p99", 512)):
            idx = chip_smoke._bag_ids(g, dev, v, b, 100)
            for mode in ("sum", "mean"):
                def run(table=table, idx=idx, mode=mode):
                    return ops.embedding_bag(table, idx, mode=mode)
                print(json.dumps(dict(
                    src=str(src), card=card, role=role, V=v, B=b, mode=mode,
                    ms=chip_smoke.time_ms(run),
                    device_ms=chip_smoke.time_graph_ms(run))), flush=True)
        del table
    return 0


if __name__ == "__main__":
    sys.exit(main())
