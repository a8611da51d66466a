"""qwen3-0.6b [hf:Qwen/Qwen3-8B family; dense] — 28L d1024 16H (GQA kv=8)
d_ff=3072 vocab=151936, qk-norm, explicit head_dim=128 (Qwen3 style).

Role in the bi-metric system: the cheap proxy tower d (small, local). The
port's ``TransformerConfig``, field for field the JAX package's
``repro.configs.qwen3_0_6b``."""
import torch

from repro_torch.configs.lm_common import make_lm_arch
from repro_torch.models.transformer import TransformerConfig
from repro_torch.train.optimizer import AdamWConfig


def full() -> TransformerConfig:
    return TransformerConfig(
        name="qwen3-0.6b", n_layers=28, d_model=1024, n_heads=16,
        n_kv_heads=8, head_dim=128, d_ff=3072, vocab=151936,
        qk_norm=True, rope_theta=1e6, dtype=torch.bfloat16, remat="full",
        embed_dim=384,
    )


def smoke() -> TransformerConfig:
    return TransformerConfig(
        name="qwen3-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=32, d_ff=128, vocab=512, qk_norm=True, embed_dim=32,
    )


SPEC = make_lm_arch("qwen3-0.6b", full, smoke, AdamWConfig())
