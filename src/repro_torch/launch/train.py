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
``--arch`` resolves through the registry (``configs.get_arch``); an arch
of another family than the LMs is refused with JAX's message. A config
whose training state (weights, their f32 master copy, gradients and
AdamW's moments) exceeds the device's memory is refused before a weight
is drawn: ``--preset full`` of granite-20b needs ≈ 446 GB,
deepseek-coder-33b ≈ 530 GB and deepseek-v3-671b terabytes.
"""
from __future__ import annotations

import argparse
import os

import torch

from repro_torch.configs import get_arch
from repro_torch.data.pipeline import DeterministicIterator, lm_batch_fn
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import transformer as T
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


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

    spec = get_arch(args.arch)
    if spec.family != "lm":
        raise SystemExit("train launcher currently drives the LM family; "
                         "see examples/ for GNN/recsys training loops")
    cfg = spec.make_config(args.preset == "smoke")
    opt = AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=max(args.steps, 100))
    need, have = train_state_bytes(cfg, opt), device_bytes(args.device)
    if need > have:
        raise ValueError(
            f"arch {args.arch!r} preset {args.preset!r}: its training state "
            f"needs {need:,} bytes (weights, f32 master copy, gradients, "
            f"moments), more than the device's {have:,}")
    model = spec.init_params(0, cfg, device=args.device)
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
