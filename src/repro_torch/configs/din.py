"""din [arXiv:1706.06978] — Deep Interest Network. embed 18, seq 100,
attention MLP 80-40, head MLP 200-80, item vocab 2^20.

Role: expensive pair scorer D (target attention over the user history).
The port's ``DINConfig``, field for field the JAX package's."""
from repro_torch.models import recsys as R


def full() -> R.DINConfig:
    return R.DINConfig(name="din", vocab=1_048_576, embed_dim=18, seq_len=100,
                       attn_mlp=(80, 40), mlp_dims=(200, 80))


def smoke() -> R.DINConfig:
    return R.DINConfig(name="din-smoke", vocab=512, embed_dim=8, seq_len=16,
                       attn_mlp=(16, 8), mlp_dims=(32, 16))
