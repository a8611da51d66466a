"""granite-20b [arXiv:2405.04324; dense code model] — 52L d6144 48H (MQA,
kv=1) d_ff=24576 vocab=49152, llama-style blocks.

Role: mid-tier expensive tower D. The port's ``TransformerConfig``, field
for field the JAX package's ``repro.configs.granite_20b``. Its 27.9 G
parameters (55.7 GB in bf16) fit one card for serving; its training state
(≈ 446 GB) does not, and ``launch/train.py`` refuses ``--preset full``."""
import torch

from repro_torch.configs.lm_common import make_lm_arch
from repro_torch.models.transformer import TransformerConfig
from repro_torch.train.optimizer import AdamWConfig


def full() -> TransformerConfig:
    return TransformerConfig(
        name="granite-20b", n_layers=52, d_model=6144, n_heads=48,
        n_kv_heads=1, head_dim=128, d_ff=24576, vocab=49152,
        dtype=torch.bfloat16, remat="full", embed_dim=1024, block_kv=1024,
    )


def smoke() -> TransformerConfig:
    return TransformerConfig(
        name="granite-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=1,
        head_dim=16, d_ff=256, vocab=512, embed_dim=32,
    )


SPEC = make_lm_arch("granite-20b", full, smoke, AdamWConfig())
