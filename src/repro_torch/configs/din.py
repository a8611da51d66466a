"""din [arXiv:1706.06978] — Deep Interest Network. embed 18, seq 100,
attention MLP 80-40, head MLP 200-80, item vocab 2^20.

Role: expensive pair scorer D (target attention over the user history).
The port's ``DINConfig``, field for field the JAX package's."""
import torch

from repro_torch.configs.common import sds
from repro_torch.configs.recsys_common import cand_ids_abs, make_recsys_arch
from repro_torch.models import recsys as R


def full() -> R.DINConfig:
    return R.DINConfig(name="din", vocab=1_048_576, embed_dim=18, seq_len=100,
                       attn_mlp=(80, 40), mlp_dims=(200, 80))


def smoke() -> R.DINConfig:
    return R.DINConfig(name="din-smoke", vocab=512, embed_dim=8, seq_len=16,
                       attn_mlp=(16, 8), mlp_dims=(32, 16))


def _batch_abs(cfg, batch):
    return {"hist": sds((batch, cfg.seq_len), torch.int32),
            "target": sds((batch,), torch.int32),
            "label": sds((batch,), torch.float32)}


SPEC = make_recsys_arch(
    "din",
    full_cfg_fn=full, smoke_cfg_fn=smoke,
    init_fn=R.din_init, model_fn=R.DIN, loss_fn=R.din_loss,
    serve_fn=lambda model, batch: R.din_forward(model, batch["hist"],
                                                batch["target"]),
    retrieval_fn=lambda model, user, cand: R.din_score_candidates(
        model, user["hist"], cand),
    batch_abs_fn=_batch_abs,
    user_abs_fn=lambda cfg: {"hist": sds((1, cfg.seq_len), torch.int32)},
    cand_abs_fn=cand_ids_abs,
)
