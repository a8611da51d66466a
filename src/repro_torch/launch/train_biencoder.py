"""End-to-end driver, the twin of ``examples/train_biencoder.py``: train a
proxy embedding tower with InfoNCE, then build a bi-metric index over its
embeddings and query it under a D-call budget.

The production loop: data pipeline -> contrastive training (with
checkpoint/restart) -> corpus embedding -> index build (cheap metric only)
-> budgeted two-stage retrieval against a bigger tower.

    python -m repro_torch.launch.train_biencoder --steps 200   # full
    python -m repro_torch.launch.train_biencoder --steps 20    # quick

Runs on the card; ``--device cpu`` runs the plain versions on the CPU.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.configs import qwen3_0_6b
from repro_torch.core import bimetric, distances, metrics, vamana
from repro_torch.data.pipeline import DeterministicIterator, contrastive_batch_fn
from repro_torch.models import transformer as T
from repro_torch.train.contrastive import info_nce_loss
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

N_DOCS = 1024
N_QUERIES = 16
QUOTA = 96


def proxy_100m() -> T.TransformerConfig:
    """The ~100M-parameter proxy tower of ``--scale 100m``."""
    return T.TransformerConfig(
        name="proxy-100m", n_layers=12, d_model=768, n_heads=12,
        n_kv_heads=12, head_dim=64, d_ff=2048, vocab=32768,
        qk_norm=True, embed_dim=384)


def teacher(vocab: int) -> T.TransformerConfig:
    """A wider random tower, standing in for the API-tier model (D)."""
    return T.TransformerConfig(
        name="teacher", n_layers=4, d_model=128, n_heads=8, n_kv_heads=8,
        head_dim=16, d_ff=256, vocab=vocab, embed_dim=64)


def _embed(model: T.Transformer, tokens: np.ndarray) -> torch.Tensor:
    """Unit embeddings of ``tokens`` in batches of 128."""
    dev = model.embed.device
    with torch.no_grad():
        return torch.cat([T.embed_pool(model, torch.as_tensor(
            tokens[s:s + 128]).to(dev)) for s in range(0, len(tokens), 128)])


def main(argv=None) -> dict:
    """Returns the losses, the step trained from, and recall@10."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=24)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "biencoder_ckpt"))
    ap.add_argument("--scale", choices=["smoke", "100m"], default="smoke",
                    help="100m trains a ~100M-param tower")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = args.device

    cfg = proxy_100m() if args.scale == "100m" else qwen3_0_6b.smoke()
    model = T.init_params(0, cfg, device=dev)
    n = sum(p.numel() for p in model.parameters())
    print(f"proxy tower: {n/1e6:.1f}M params")

    # ---- contrastive training with checkpoint/restart -------------------
    opt = AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=max(args.steps, 100))
    trainer = Trainer(
        info_nce_loss, model, opt,
        TrainerConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                      ckpt_every=max(args.steps // 4, 10), log_every=10),
        device=dev)
    del model  # the trainer trains its own copy
    make = contrastive_batch_fn(args.batch, args.seq, cfg.vocab)
    it = DeterministicIterator(make)
    state = trainer.maybe_restore(it.state())
    it = DeterministicIterator.from_state(make, state)
    resumed_from = trainer.step
    if resumed_from:
        print(f"resumed from step {resumed_from}")
    out = trainer.run(it, data_state_fn=it.state)
    print(f"trained to loss {out['final_loss']:.4f}")

    # ---- embed a corpus with the trained proxy; D = teacher tower -------
    rng = np.random.default_rng(0)
    corpus_tokens = rng.integers(0, cfg.vocab, (N_DOCS, args.seq),
                                 dtype=np.int32)
    emb_d = _embed(trainer.params, corpus_tokens)
    tmodel = T.init_params(7, teacher(cfg.vocab), device=dev)
    emb_D = _embed(tmodel, corpus_tokens)

    index = vamana.build(emb_d, vamana.VamanaConfig(
        max_degree=16, l_build=24, pool_size=48, rev_candidates=16),
        device=dev)
    qidx = rng.integers(0, N_DOCS, N_QUERIES)
    q_tokens = corpus_tokens[qidx].copy()
    q_tokens[:, : args.seq // 2] = rng.integers(0, cfg.vocab,
                                                (N_QUERIES, args.seq // 2))
    q_d = _embed(trainer.params, q_tokens)
    q_D = _embed(tmodel, q_tokens)
    em_d = distances.EmbeddingMetric(emb_d)
    em_D = distances.EmbeddingMetric(emb_D)
    true_ids, _ = em_D.brute_force(q_D, 10)
    res = bimetric.bimetric_search(
        em_d.dists_batch, em_D.dists_batch, index, q_d, q_D,
        n_points=N_DOCS, quota=QUOTA, k=10, device=dev)
    rec = float(metrics.recall_at_k(res.ids, true_ids).float().mean())
    print(f"bi-metric retrieval vs teacher: recall@10={rec:.3f} at Q={QUOTA} "
          f"(corpus={N_DOCS})")
    return {"losses": out["losses"], "resumed_from": resumed_from,
            "recall_at_10": rec, "D_calls": res.D_calls.tolist()}


if __name__ == "__main__":
    main()
