"""xdeepfm [arXiv:1803.05170] — 39 fields × embed 10, CIN 200-200-200,
DNN 400-400, per-field vocab 2^20 (one stacked 39×2^20-row table).

Role: expensive pointwise ranker D (CIN crosses candidate × user fields).
The port's ``XDeepFMConfig``, field for field the JAX package's."""
from repro_torch.models import recsys as R


def full() -> R.XDeepFMConfig:
    return R.XDeepFMConfig(name="xdeepfm", n_fields=39, field_vocab=1_048_576,
                           embed_dim=10, cin_layers=(200, 200, 200),
                           mlp_dims=(400, 400), n_item_fields=13)


def smoke() -> R.XDeepFMConfig:
    return R.XDeepFMConfig(name="xdeepfm-smoke", n_fields=39, field_vocab=256,
                           embed_dim=4, cin_layers=(16, 16),
                           mlp_dims=(32, 32), n_item_fields=13)
