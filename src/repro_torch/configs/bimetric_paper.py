"""The paper's own experimental configuration (§4.1).

Two embedding towers at a 3-orders-of-magnitude size gap (Table 1) and the
DiskANN index parameters the paper uses ("standard ANN-benchmark choices":
alpha=1.2, l_build=125, max_outdegree=64). The expensive tower also
registers as an extra LM arch ("sfr-mistral-7b").
"""
import dataclasses

import torch

from repro_torch.configs.lm_common import make_lm_arch
from repro_torch.core.vamana import VamanaConfig
from repro_torch.models.transformer import TransformerConfig
from repro_torch.train.optimizer import AdamWConfig

#: D: SFR-Embedding-Mistral-like 7B encoder, 4096-dim embeddings
EXPENSIVE_EMBED_DIM = 4096
#: d: bge-micro-v2-like 17M encoder, 384-dim embeddings
CHEAP_EMBED_DIM = 384


def expensive_tower() -> TransformerConfig:
    """SFR-Embedding-Mistral-like 7B encoder (D)."""
    return TransformerConfig(
        name="sfr-mistral-7b", n_layers=32, d_model=4096, n_heads=32,
        n_kv_heads=8, head_dim=128, d_ff=14336, vocab=32768,
        dtype=torch.bfloat16, remat="full", embed_dim=EXPENSIVE_EMBED_DIM,
        rope_theta=1e6,
    )


def cheap_tower() -> TransformerConfig:
    """bge-micro-v2-like 17M encoder (d): 3 layers, 384-dim embeddings."""
    return TransformerConfig(
        name="bge-micro-like", n_layers=3, d_model=384, n_heads=6,
        n_kv_heads=6, head_dim=64, d_ff=1536, vocab=32768,
        dtype=torch.float32, embed_dim=CHEAP_EMBED_DIM,
    )


def cheap_tower_smoke() -> TransformerConfig:
    return TransformerConfig(
        name="bge-micro-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=128, vocab=512, embed_dim=32,
    )


# Paper §4.1 index parameters (DiskANN / ANN-benchmarks standard).
PAPER_DISKANN = VamanaConfig(
    max_degree=64, l_build=125, alpha=1.2, pool_size=256,
    rev_candidates=64, metric="l2",
)


@dataclasses.dataclass(frozen=True)
class BiMetricSystemConfig:
    """End-to-end system: index + query policy (paper defaults)."""

    index: VamanaConfig = PAPER_DISKANN
    k: int = 10  # report top-10 (paper metric: NDCG@10 / Recall@10)
    seed_frac: float = 0.5  # stage-2 seeds = Q/2 (Figure 3 default)
    quota: int = 1000  # expensive-call budget Q (swept in benchmarks)


SPEC = make_lm_arch("sfr-mistral-7b", expensive_tower, cheap_tower_smoke,
                    AdamWConfig())
