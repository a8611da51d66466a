"""deepseek-v3-671b [arXiv:2412.19437; MoE+MLA] — 61L d7168 128H MLA,
1 shared + 256 routed experts top-8 (per-expert d_ff=2048), first 3 layers
dense (d_ff=18432), MTP head, vocab=129280.

The port's ``TransformerConfig``, field for field the JAX package's
``repro.configs.deepseek_v3_671b``, and its optimizer (int8-quantized Adam
moments). Its 671 B parameters do not fit one card: ``launch/train.py``
refuses ``--preset full`` for it before drawing a weight."""
import torch

from repro_torch.configs.lm_common import make_lm_arch
from repro_torch.models.transformer import TransformerConfig
from repro_torch.train.optimizer import AdamWConfig


def full() -> TransformerConfig:
    return TransformerConfig(
        name="deepseek-v3-671b", n_layers=61, d_model=7168, n_heads=128,
        n_kv_heads=128, head_dim=128, d_ff=18432, vocab=129280,
        moe=True, n_experts=256, top_k=8, moe_d_ff=2048, n_shared=1,
        first_dense=3,
        mla=True, q_lora_rank=1536, kv_lora_rank=512, qk_nope_dim=128,
        qk_rope_dim=64, v_head_dim=128, mtp=True,
        dtype=torch.bfloat16, remat="full", embed_dim=4096, block_kv=1024,
    )


def smoke() -> TransformerConfig:
    return TransformerConfig(
        name="dsv3-smoke", n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=128, vocab=512,
        moe=True, n_experts=8, top_k=2, moe_d_ff=32, n_shared=1,
        first_dense=1,
        mla=True, q_lora_rank=32, kv_lora_rank=24, qk_nope_dim=16,
        qk_rope_dim=8, v_head_dim=16, mtp=True, embed_dim=32,
        capacity_factor=4.0,
    )


OPT = AdamWConfig(quantized_state=True)
SPEC = make_lm_arch("deepseek-v3-671b", full, smoke, OPT)
