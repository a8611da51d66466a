#!/usr/bin/env python3
"""Time the attention kernels at the towers' and the decode cache's
shapes, for an A/B of two checkouts.

    python3 scripts/time_attention.py [--src DIR]

Imports ``repro_torch`` from DIR (default: this checkout's ``src``), builds
its kernels into that checkout's ``build/``, and prints one JSON line per
shape with the card's name and power limit, all in ms of CUDA events around
back-to-back calls (``chip_smoke.time_ms``):

* ``forward_ms``: the inference forward, ``ops.flash_attention`` under
  ``torch.inference_mode()``, at ``chip_smoke.py`` phase 6's prefill layers
  (sfr-mistral-7b B=1 H=32 S=4096 d=128 bf16, bge-micro-like B=256 H=6
  S=512 d=64 f32) and phase 8's doc (S=256) and query (S=32) batches of
  both towers (B=64; D's 8 KV heads repeated to 32);
* ``train_ms``: the training path at the doc batches, the forward under
  autograd and its backward (``out.backward(dout)``) in one call;
* ``backward_ms``: ``flash_attention_bwd`` alone at d's and D's training
  layers (B=64 H=6 S=256 d=64 f32; B=4 H=32 S=256 d=128 bf16, causal),
  given the forward's log-sum-exp where the checkout has
  ``flash_attention_lse``;
* ``decode_ms``: ``ops.flash_decode`` at ``chip_smoke.py`` phase 6's
  decode rows, with the max |kernel - plain|: sfr-mistral-7b at
  decode_32k (B=8 H=32 S=32,768 d=128 bf16, one kv head per query head,
  lengths seeded in [1, S]; and B=1 with the full cache), then
  qwen3-0.6b's grouped cache (16 query heads over 8 kv heads, and MQA); a
  checkout that refuses a grouped cache prints ``"grouped": false`` for
  those rows.

Run it for each checkout in turns in one call (parent, change, change,
parent). Needs one CUDA device; imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# role, B, H, S, d, dtype name: the inference forward's shapes
FORWARD = [
    ("sfr-mistral-7b prefill", 1, 32, 4096, 128, "bfloat16"),
    ("bge-micro-like prefill", 256, 6, 512, 64, "float32"),
    ("D doc batch", 64, 32, 256, 128, "bfloat16"),
    ("d doc batch", 64, 6, 256, 64, "float32"),
    ("D query batch", 64, 32, 32, 128, "bfloat16"),
    ("d query batch", 64, 6, 32, 64, "float32"),
]
# the backward's layers
BACKWARD = [
    ("d training layer", 64, 6, 256, 64, "float32"),
    ("D layer", 4, 32, 256, 128, "bfloat16"),
]
# role, B, H, Hkv, S, d, lengths ("full" or seeded in [1, S]), all bf16
DECODE = [
    ("sfr-mistral-7b decode_32k, B=8", 8, 32, 32, 32768, 128, "seeded"),
    ("sfr-mistral-7b decode_32k, B=1, full cache", 1, 32, 32, 32768, 128,
     "full"),
    ("qwen3-0.6b decode_32k, B=8, GQA 16 over 8", 8, 16, 8, 32768, 128,
     "seeded"),
    ("qwen3-0.6b decode_32k, B=8, MQA", 8, 16, 1, 32768, 128, "seeded"),
]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src/ directory whose repro_torch is timed")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke  # its timers; it imports no repro_torch yet
    import torch

    if not torch.cuda.is_available():
        print("time_attention: no CUDA device is visible", file=sys.stderr)
        return 2
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    from repro_torch.kernels import flash_attention as fa
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

    def emit(**row):
        print(json.dumps(dict(src=str(src), card=card, **row)), flush=True)

    for role, b, h, s, d, name in FORWARD:
        dt = getattr(torch, name)
        q, k, v = chip_smoke._attn_inputs(g, dev, b, h, s, s, d, d, dt)
        with torch.inference_mode():
            fwd = chip_smoke.time_ms(lambda: ops.flash_attention(q, k, v))
        row = dict(role=role, B=b, H=h, S=s, d=d, dtype=name, forward_ms=fwd)
        if role.endswith("doc batch"):
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            dout = torch.randn(b, h, s, d, generator=g, device=dev).to(dt)

            def train():
                ops.flash_attention(*leaves).backward(dout)

            row["train_ms"] = chip_smoke.time_ms(train)
        emit(**row)
        del q, k, v
    for role, b, h, s, d, name in BACKWARD:
        dt = getattr(torch, name)
        q, k, v = chip_smoke._attn_inputs(g, dev, b, h, s, s, d, d, dt)
        dout = torch.randn(b, h, s, d, generator=g, device=dev).to(dt)
        extra = {}
        with torch.inference_mode():
            if hasattr(fa, "flash_attention_lse"):
                out, lse = fa.flash_attention_lse(q, k, v)
                extra["lse"] = lse
            else:
                out = ops.flash_attention(q, k, v)
        emit(role=role, B=b, H=h, S=s, d=d, dtype=name,
             given_lse="lse" in extra,
             backward_ms=chip_smoke.time_ms(
                 lambda: fa.flash_attention_bwd(q, k, v, out, dout, **extra)))
        del q, k, v, out, dout, extra
    for role, b, h, hkv, s, d, lengths in DECODE:
        g = torch.Generator(device=dev).manual_seed(17)
        q, k, v = (torch.randn(b, *shape, generator=g, device=dev,
                               dtype=torch.bfloat16)
                   for shape in ((h, d), (s, hkv, d), (s, hkv, d)))
        length = (torch.full((b,), s, device=dev, dtype=torch.int32)
                  if lengths == "full" else
                  torch.randint(1, s + 1, (b,), generator=g, device=dev,
                                dtype=torch.int32))
        row = dict(role=role, B=b, H=h, Hkv=hkv, S=s, d=d,
                   valid_keys=int(length.sum()))
        with torch.inference_mode():
            try:
                got = ops.flash_decode(q, k, v, length=length)
            except ValueError:
                emit(**row, grouped=False)
                continue
            want = fa.flash_decode_plain(q, k, v, length=length)
            row["max_abs_err"] = float((got.float() - want.float()).abs().max())
            row["decode_ms"] = chip_smoke.time_ms(
                lambda: ops.flash_decode(q, k, v, length=length))
        emit(**row)
        del q, k, v, got, want
    return 0


if __name__ == "__main__":
    sys.exit(main())
