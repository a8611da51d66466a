"""bst [arXiv:1905.06874] — Behavior Sequence Transformer (Alibaba).
embed 32, seq 20, 1 block × 8 heads, MLP 1024-512-256, item vocab 2^20.

Role: expensive pair scorer D (target is attended jointly with the history —
non-factorizable, so retrieval under a budget is the paper's exact regime).
The port's ``BSTConfig``, field for field the JAX package's."""
import torch

from repro_torch.configs.common import sds
from repro_torch.configs.recsys_common import cand_ids_abs, make_recsys_arch
from repro_torch.models import recsys as R


def full() -> R.BSTConfig:
    return R.BSTConfig(name="bst", vocab=1_048_576, embed_dim=32, seq_len=20,
                       n_blocks=1, n_heads=8, mlp_dims=(1024, 512, 256))


def smoke() -> R.BSTConfig:
    return R.BSTConfig(name="bst-smoke", vocab=512, embed_dim=16, seq_len=8,
                       n_blocks=1, n_heads=4, mlp_dims=(64, 32))


def _batch_abs(cfg, batch):
    return {"hist": sds((batch, cfg.seq_len), torch.int32),
            "target": sds((batch,), torch.int32),
            "label": sds((batch,), torch.float32)}


SPEC = make_recsys_arch(
    "bst",
    full_cfg_fn=full, smoke_cfg_fn=smoke,
    init_fn=R.bst_init, model_fn=R.BST, loss_fn=R.bst_loss,
    serve_fn=lambda model, batch: R.bst_forward(model, batch["hist"],
                                                batch["target"]),
    retrieval_fn=lambda model, user, cand: R.bst_score_candidates(
        model, user["hist"], cand),
    batch_abs_fn=_batch_abs,
    user_abs_fn=lambda cfg: {"hist": sds((1, cfg.seq_len), torch.int32)},
    cand_abs_fn=cand_ids_abs,
)
