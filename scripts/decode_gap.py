#!/usr/bin/env python3
"""Where the gap between ``chip_smoke.py`` phase 12(a)'s decode logits and
the forward's comes from.

    python3 scripts/decode_gap.py [--rows N]

Draws qwen3-0.6b at full width, its prompts (8 x 32,704 tokens) and its
greedy decode as phase 12(a) does (bf16, 64 steps to a full 32,768 cache),
and compares the first and last step's logits with the forward's on the
same tokens: the gated pair. Then the first N rows (default 2) go again
through an f32 copy of the same weights (an f32 cache, the f32 kernels),
fed the bf16 run's tokens, and three more pairs are compared at each of
the two steps:

* f32 decode against f32 forward: a real difference of the decode path
  (RoPE at a wrong position, a wrong cache slot) shows here, bf16
  rounding does not;
* bf16 decode, and bf16 forward, each against the f32 forward: which side
  carries the gap.

Prints one JSON line per pair with the card's name and power limit
(``chip_smoke._logits_gap``: the least cosine of a row, max |diff| over
max |logit|, the root-mean-square ratio, where max |diff| falls). Needs
one CUDA device; imports no JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
# phase 12(a): seed, batch, prompt length, cache length
SEED, BATCH, PROMPT, MAX_SEQ = 0, 8, 32704, 32768


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=2,
                    help="rows of the batch run again in f32")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke
    import torch

    if not torch.cuda.is_available():
        print("decode_gap: no CUDA device is visible", file=sys.stderr)
        return 2
    from repro_torch.configs import qwen3_0_6b
    from repro_torch.models import transformer as T

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    cfg = qwen3_0_6b.full()
    n, r = MAX_SEQ - PROMPT, args.rows
    ends = {"first": (0, PROMPT + 1), "last": (n - 1, MAX_SEQ)}

    def emit(pair, step, got, want):
        print(json.dumps(dict(card=card, pair=pair, step=step,
                              rows=got.shape[0],
                              **chip_smoke._logits_gap(got, want))),
              flush=True)

    def decode(model, prompts, toks):
        """Each step's logits at ``ends``; greedy when ``toks`` is None,
        else fed ``toks``. Returns (logits by end, the tokens fed)."""
        out = {}
        logits, cache = T.prefill(model, prompts, max_seq=MAX_SEQ)
        fed = [logits[:, -1].argmax(-1, keepdim=True)] if toks is None else toks
        for i in range(n):
            lg, cache = T.decode_step(model, fed[i], cache)
            for name, (at, _) in ends.items():
                if i == at:
                    out[name] = lg[:, 0].float()
            if toks is None:
                fed.append(lg[:, -1].argmax(-1, keepdim=True))
        return out, fed

    def forward(model, seq):
        out = {}
        for name, (_, upto) in ends.items():
            hid = T.forward(model, seq[:, :upto], with_logits=False).hidden
            out[name] = (hid[:, -1] @ model.embed.T).float()
            del hid
        return out

    model = T.init_params(SEED, cfg, device=dev)
    rng = np.random.default_rng(SEED)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab,
                                            (BATCH, PROMPT))).to(dev)
    with torch.inference_mode():
        dec16, toks = decode(model, prompts, None)
        seq = torch.cat([prompts] + toks[:-1], dim=1)
        fwd16 = forward(model, seq)
        for name in ends:
            emit("bf16 decode vs bf16 forward", name, dec16[name], fwd16[name])
        m32 = T.Transformer(dataclasses.replace(cfg, dtype=torch.float32),
                            device=dev)
        m32.load_state_dict(model.state_dict())
        del model
        dec32, _ = decode(m32, prompts[:r], [t[:r] for t in toks])
        fwd32 = forward(m32, seq[:r])
        for name in ends:
            emit("f32 decode vs f32 forward", name, dec32[name], fwd32[name])
            emit("bf16 decode vs f32 forward", name, dec16[name][:r],
                 fwd32[name])
            emit("bf16 forward vs f32 forward", name, fwd16[name][:r],
                 fwd32[name])
            emit("bf16 decode vs bf16 forward", name, dec16[name][:r],
                 fwd16[name][:r])
    return 0


if __name__ == "__main__":
    sys.exit(main())
