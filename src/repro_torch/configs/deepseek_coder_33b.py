"""deepseek-coder-33b [arXiv:2401.14196; dense] — 62L d7168 56H (GQA kv=8)
d_ff=19200 vocab=32256, llama-arch.

Role: expensive tower D. The port's ``TransformerConfig``, field for field
the JAX package's ``repro.configs.deepseek_coder_33b``. Its 33.1 G
parameters (66.3 GB in bf16) fit one card for serving; its training state
(≈ 530 GB) does not, and ``launch/train.py`` refuses ``--preset full``."""
import torch

from repro_torch.configs.lm_common import make_lm_arch
from repro_torch.models.transformer import TransformerConfig
from repro_torch.train.optimizer import AdamWConfig


def full() -> TransformerConfig:
    return TransformerConfig(
        name="deepseek-coder-33b", n_layers=62, d_model=7168, n_heads=56,
        n_kv_heads=8, head_dim=128, d_ff=19200, vocab=32256,
        dtype=torch.bfloat16, remat="full", embed_dim=2048, block_kv=1024,
    )


def smoke() -> TransformerConfig:
    return TransformerConfig(
        name="dsc-smoke", n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
        head_dim=8, d_ff=192, vocab=512, embed_dim=32,
    )


SPEC = make_lm_arch("deepseek-coder-33b", full, smoke, AdamWConfig())
