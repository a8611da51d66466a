"""bst [arXiv:1905.06874] — Behavior Sequence Transformer (Alibaba).
embed 32, seq 20, 1 block × 8 heads, MLP 1024-512-256, item vocab 2^20.

Role: expensive pair scorer D (target is attended jointly with the history —
non-factorizable, so retrieval under a budget is the paper's exact regime).
The port's ``BSTConfig``, field for field the JAX package's."""
from repro_torch.models import recsys as R


def full() -> R.BSTConfig:
    return R.BSTConfig(name="bst", vocab=1_048_576, embed_dim=32, seq_len=20,
                       n_blocks=1, n_heads=8, mlp_dims=(1024, 512, 256))


def smoke() -> R.BSTConfig:
    return R.BSTConfig(name="bst-smoke", vocab=512, embed_dim=16, seq_len=8,
                       n_blocks=1, n_heads=4, mlp_dims=(64, 32))
