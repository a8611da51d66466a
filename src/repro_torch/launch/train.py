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
"""
from __future__ import annotations

import argparse

from repro_torch.configs import bimetric_paper, qwen3_0_6b
from repro_torch.data.pipeline import DeterministicIterator, lm_batch_fn
from repro_torch.models import transformer as T
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

#: the dense LM configs the port has: (full, smoke)
ARCHS = {
    "qwen3-0.6b": (qwen3_0_6b.full, qwen3_0_6b.smoke),
    "sfr-mistral-7b": (bimetric_paper.expensive_tower,
                       bimetric_paper.cheap_tower_smoke),
}
#: the JAX registry's other LM and GNN archs, by the ROADMAP item (queue
#: 1) that ports them
LATER = {
    "granite-moe-3b-a800m": 6, "deepseek-v3-671b": 6,
    "gat-cora": 7,
    "granite-20b": 8, "deepseek-coder-33b": 8,
}
#: the recommender archs (``models/recsys.py``): not of the LM family, which
#: this launcher drives, as JAX's refuses them
RECSYS = ("bst", "din", "bert4rec", "xdeepfm")


def get_config(arch: str, smoke: bool) -> T.TransformerConfig:
    if arch in ARCHS:
        return ARCHS[arch][1 if smoke else 0]()
    if arch in RECSYS:
        raise SystemExit("train launcher currently drives the LM family; "
                         "see examples/ for GNN/recsys training loops")
    if arch in LATER:
        raise ValueError(f"arch {arch!r} is not ported yet (ROADMAP.md, "
                         f"queue 1, item {LATER[arch]})")
    raise ValueError(f"unknown arch {arch!r}; choose from {sorted(ARCHS)}")


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
    model = T.init_params(0, cfg, device=args.device)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"arch={args.arch} preset={args.preset} params={n_params/1e6:.1f}M")

    opt = AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=max(args.steps, 100))
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
