"""Training launcher, the twin of ``repro.launch.train``:

    python -m repro_torch.launch.train --arch qwen3-0.6b --preset smoke --steps 50

Presets:
  smoke — the reduced config, runs in seconds;
  full  — the exact assigned config (one card).

Runs the LM loss (``transformer.loss_fn``) under the ``Trainer`` on
``lm_batch_fn`` batches. Fault tolerance as in JAX's: checkpoints land in
``--ckpt-dir``, and a killed run resumes (params, optimizer, data cursor)
through ``Trainer.maybe_restore`` and ``DeterministicIterator.from_state``.
Runs on the card; ``--device cpu`` runs the plain versions on the CPU.
A config whose training state (weights, their f32 master copy, gradients
and AdamW's moments) exceeds the device's memory is refused before a
weight is drawn: ``--arch deepseek-v3-671b --preset full`` needs terabytes.
"""
from __future__ import annotations

import argparse
import os

import torch

from repro_torch.configs import (bimetric_paper, deepseek_v3_671b,
                                 granite_moe_3b_a800m, qwen3_0_6b)
from repro_torch.kernels.backend import resolve_device
from repro_torch.data.pipeline import DeterministicIterator, lm_batch_fn
from repro_torch.models import transformer as T
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

#: the LM configs the port has: (full, smoke)
ARCHS = {
    "qwen3-0.6b": (qwen3_0_6b.full, qwen3_0_6b.smoke),
    "sfr-mistral-7b": (bimetric_paper.expensive_tower,
                       bimetric_paper.cheap_tower_smoke),
    "granite-moe-3b-a800m": (granite_moe_3b_a800m.full,
                             granite_moe_3b_a800m.smoke),
    "deepseek-v3-671b": (deepseek_v3_671b.full, deepseek_v3_671b.smoke),
}
#: the JAX registry's other LM archs, by the ROADMAP item (queue 1) that
#: ports them
LATER = {"granite-20b": 8, "deepseek-coder-33b": 8}
#: the recommender archs (``models/recsys.py``) and the GNN
#: (``models/gnn.py``): not of the LM family, which this launcher drives,
#: as JAX's refuses them
RECSYS = ("bst", "din", "bert4rec", "xdeepfm")
GNN = ("gat-cora",)


def get_config(arch: str, smoke: bool) -> T.TransformerConfig:
    if arch in ARCHS:
        return ARCHS[arch][1 if smoke else 0]()
    if arch in RECSYS or arch in GNN:
        raise SystemExit("train launcher currently drives the LM family; "
                         "see examples/ for GNN/recsys training loops")
    if arch in LATER:
        raise ValueError(f"arch {arch!r} is not ported yet (ROADMAP.md, "
                         f"queue 1, item {LATER[arch]})")
    raise ValueError(f"unknown arch {arch!r}; choose from {sorted(ARCHS)}")


def train_state_bytes(cfg: T.TransformerConfig, opt: AdamWConfig) -> int:
    """Bytes of ``cfg``'s training state: the weights, their f32 master
    copy, gradients of the weights' type and AdamW's two moments (int8 or
    f32), counted on the meta device (nothing is allocated)."""
    model = T.Transformer(cfg, device="meta")
    moment = 1 if opt.quantized_state else 4
    return sum(p.numel() * (2 * p.element_size() + 4 + 2 * moment)
               for p in model.parameters())


def device_bytes(device) -> int:
    """Memory of ``device``: the card's, or the host's physical memory."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_properties(dev).total_memory
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def main(argv=None):
    """Returns (the trainer, ``Trainer.run``'s result)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--preset", choices=["smoke", "full"], default="smoke")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--topk-compress", type=float, default=0.0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, args.preset == "smoke")
    opt = AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=max(args.steps, 100))
    need, have = train_state_bytes(cfg, opt), device_bytes(args.device)
    if need > have:
        raise ValueError(
            f"arch {args.arch!r} preset {args.preset!r}: its training state "
            f"needs {need:,} bytes (weights, f32 master copy, gradients, "
            f"moments), more than the device's {have:,}")
    model = T.init_params(0, cfg, device=args.device)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"arch={args.arch} preset={args.preset} params={n_params/1e6:.1f}M")

    tcfg = TrainerConfig(total_steps=args.steps, grad_accum=args.grad_accum,
                         ckpt_dir=args.ckpt_dir,
                         ckpt_every=max(args.steps // 3, 10),
                         topk_compress=args.topk_compress, log_every=5)
    trainer = Trainer(T.loss_fn, model, opt, tcfg, device=args.device)
    del model  # the trainer trains its own copy
    make = lm_batch_fn(args.batch, args.seq, cfg.vocab)
    it = DeterministicIterator(make)
    state = trainer.maybe_restore(it.state())
    if state is not None:
        it = DeterministicIterator.from_state(make, state)
    if trainer.step:
        print(f"resumed from step {trainer.step}")
    out = trainer.run(it, data_state_fn=it.state)
    print(f"final loss {out['final_loss']:.4f} "
          f"stragglers={len(out['stragglers'])}")
    return trainer, out


if __name__ == "__main__":
    main()
