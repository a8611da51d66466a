"""The paper's own experimental configuration (§4.1).

Two embedding towers at a 3-orders-of-magnitude size gap (Table 1) and the
DiskANN index parameters the paper uses ("standard ANN-benchmark choices":
alpha=1.2, l_build=125, max_outdegree=64). Only the towers' embedding widths
are carried here; the towers themselves come with the port's model slice.
"""
import dataclasses

from repro_torch.core.vamana import VamanaConfig

#: D: SFR-Embedding-Mistral-like 7B encoder, 4096-dim embeddings
EXPENSIVE_EMBED_DIM = 4096
#: d: bge-micro-v2-like 17M encoder, 384-dim embeddings
CHEAP_EMBED_DIM = 384

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
