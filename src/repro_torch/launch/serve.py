"""Serving launcher: bi-metric search with model-backed metrics.

``python -m repro_torch.launch.serve --corpus 512 --quota 48``

Draws the cheap and expensive smoke towers from seeds, indexes a synthetic
token corpus with the cheap tower only, then serves queries under an exact
expensive-model call budget, the paper's two-stage search beside the
re-rank baseline. Runs on the card; ``--device cpu`` runs the plain
versions on the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch.configs import bimetric_paper
from repro_torch.models import transformer as T
from repro_torch.serve.engine import BiMetricEngine, EmbedTower, SearchRequest


def cheap_smoke() -> T.TransformerConfig:
    """The cheap smoke tower (the JAX launcher's ``qwen3_0_6b.smoke()``)."""
    return T.TransformerConfig(
        name="qwen3-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=32, d_ff=128, vocab=512, qk_norm=True, embed_dim=32)


def expensive_smoke() -> T.TransformerConfig:
    """The stand-in expensive tower: ``cheap_tower_smoke`` widened to 4
    layers of 128, as the JAX launcher's."""
    return dataclasses.replace(
        bimetric_paper.cheap_tower_smoke(), n_layers=4, d_model=128,
        n_heads=8, n_kv_heads=8, head_dim=16, d_ff=256, embed_dim=64,
        name="expensive-smoke")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--corpus", type=int, default=256)
    ap.add_argument("--queries", type=int, default=8)
    ap.add_argument("--quota", type=int, default=32)
    ap.add_argument("--seq", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cheap_cfg, exp_cfg = cheap_smoke(), expensive_smoke()
    cheap = EmbedTower(T.init_params(0, cheap_cfg, device=args.device),
                       device=args.device)
    expensive = EmbedTower(T.init_params(1, exp_cfg, device=args.device),
                           device=args.device)
    rng = np.random.default_rng(0)
    corpus = rng.integers(0, cheap_cfg.vocab, (args.corpus, args.seq),
                          dtype=np.int32)
    t0 = time.time()
    engine = BiMetricEngine(cheap, expensive, corpus, device=args.device)
    print(f"indexed {args.corpus} docs with the cheap tower in "
          f"{time.time()-t0:.1f}s (zero expensive calls)")

    # ground truth under D for evaluation
    emb_D = expensive.embed(corpus)
    for qi in range(args.queries):
        q = corpus[rng.integers(0, args.corpus)].copy()
        q[: args.seq // 2] = rng.integers(0, cheap_cfg.vocab, args.seq // 2)
        q_emb = expensive.embed(q[None])[0]
        true10 = np.argsort(np.linalg.norm(emb_D - q_emb, axis=1))[:10]
        res = engine.query(SearchRequest(tokens=q, quota=args.quota))
        ids_r, _, st_r = engine.rerank_query(q, quota=args.quota)
        rec_b = len(set(res.ids) & set(true10)) / 10
        rec_r = len(set(ids_r) & set(true10)) / 10
        print(f"q{qi}: bimetric recall@10={rec_b:.2f} "
              f"(D calls {res.stats.D_calls}) "
              f"| rerank recall@10={rec_r:.2f} (D calls {st_r.D_calls})")


if __name__ == "__main__":
    main()
