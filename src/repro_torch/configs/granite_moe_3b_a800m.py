"""granite-moe-3b-a800m [hf:ibm-granite/granite-3.0 family; MoE] — 32L d1536
24H (GQA kv=8) per-expert d_ff=512, vocab=49155, 40 experts top-8.

The port's ``TransformerConfig``, field for field the JAX package's
``repro.configs.granite_moe_3b_a800m`` (40 experts, top-8: its inline
spec)."""
import torch

from repro_torch.configs.lm_common import make_lm_arch
from repro_torch.models.transformer import TransformerConfig
from repro_torch.train.optimizer import AdamWConfig


def full() -> TransformerConfig:
    return TransformerConfig(
        name="granite-moe-3b-a800m", n_layers=32, d_model=1536, n_heads=24,
        n_kv_heads=8, head_dim=64, d_ff=512, vocab=49155,
        moe=True, n_experts=40, top_k=8, moe_d_ff=512, n_shared=0,
        first_dense=0, dtype=torch.bfloat16, remat="full", embed_dim=384,
    )


def smoke() -> TransformerConfig:
    return TransformerConfig(
        name="granite-moe-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=64, vocab=512,
        moe=True, n_experts=8, top_k=2, moe_d_ff=64, n_shared=0,
        first_dense=0, embed_dim=32, capacity_factor=4.0,
    )


SPEC = make_lm_arch("granite-moe-3b-a800m", full, smoke, AdamWConfig())
