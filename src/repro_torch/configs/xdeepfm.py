"""xdeepfm [arXiv:1803.05170] — 39 fields × embed 10, CIN 200-200-200,
DNN 400-400, per-field vocab 2^20 (one stacked 39×2^20-row table).

Role: expensive pointwise ranker D (CIN crosses candidate × user fields).
The port's ``XDeepFMConfig``, field for field the JAX package's."""
import torch

from repro_torch.configs.common import sds
from repro_torch.configs.recsys_common import make_recsys_arch
from repro_torch.models import recsys as R


def full() -> R.XDeepFMConfig:
    return R.XDeepFMConfig(name="xdeepfm", n_fields=39, field_vocab=1_048_576,
                           embed_dim=10, cin_layers=(200, 200, 200),
                           mlp_dims=(400, 400), n_item_fields=13)


def smoke() -> R.XDeepFMConfig:
    return R.XDeepFMConfig(name="xdeepfm-smoke", n_fields=39, field_vocab=256,
                           embed_dim=4, cin_layers=(16, 16),
                           mlp_dims=(32, 32), n_item_fields=13)


def _batch_abs(cfg, batch):
    return {"fields": sds((batch, cfg.n_fields), torch.int32),
            "label": sds((batch,), torch.float32)}


SPEC = make_recsys_arch(
    "xdeepfm",
    full_cfg_fn=full, smoke_cfg_fn=smoke,
    init_fn=R.xdeepfm_init, model_fn=R.XDeepFM, loss_fn=R.xdeepfm_loss,
    serve_fn=lambda model, batch: R.xdeepfm_forward(model, batch["fields"]),
    retrieval_fn=lambda model, user, cand: R.xdeepfm_score_candidates(
        model, user["fields"], cand),
    batch_abs_fn=_batch_abs,
    user_abs_fn=lambda cfg: {"fields": sds(
        (1, cfg.n_fields - cfg.n_item_fields), torch.int32)},
    cand_abs_fn=lambda cfg, n_cand: sds((n_cand, cfg.n_item_fields),
                                        torch.int32),
)
