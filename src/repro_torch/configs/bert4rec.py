"""bert4rec [arXiv:1904.06690] — bidirectional sequence model, embed 64,
2 blocks × 2 heads, seq 200, masked-item training (40 masked positions),
item vocab 65,536 (ML-25M scale, 16-divisible).

Encoder-only. Retrieval is factorizable (last-hidden · item embedding). The
port's ``Bert4RecConfig``, field for field the JAX package's, and JAX's
serving step (``_serve``)."""
import torch

from repro_torch.configs.common import sds
from repro_torch.configs.recsys_common import cand_ids_abs, make_recsys_arch
from repro_torch.kernels.backend import as_tensor
from repro_torch.models import recsys as R


def full() -> R.Bert4RecConfig:
    return R.Bert4RecConfig(name="bert4rec", vocab=65_536, embed_dim=64,
                            seq_len=200, n_blocks=2, n_heads=2, n_masked=40)


def smoke() -> R.Bert4RecConfig:
    return R.Bert4RecConfig(name="bert4rec-smoke", vocab=512, embed_dim=16,
                            seq_len=16, n_blocks=2, n_heads=2, n_masked=4)


def _serve(model: R.Bert4Rec, batch: dict, chunk: int = 8192):
    """Next-item top-10 over the catalogue for a batch of users: (values,
    ids), each (B, 10), best first. When B > ``chunk`` and B % chunk == 0
    the rows go in chunks of ``chunk``, so the live (b, V) logits block is
    one chunk deep; otherwise one pass.

    JAX takes a top-10 per catalogue shard, then a top-10 of those; on one
    card one ``torch.topk`` over V gives the same set in the same order.
    Ties: ``jax.lax.top_k`` puts the lower id first; ``torch.topk`` leaves
    the order of equal scores unspecified (on the card any of them may come
    first, or be the one kept at the tenth place), so the two agree where
    a row's eleven best scores are distinct."""
    items = as_tensor(batch["items"], model.item_emb.device)

    def score_rows(it):
        h = R.bert4rec_encode(model, it)[:, -1]  # (b, D)
        return torch.topk(h @ model.item_emb.T, 10, dim=-1)

    n = items.shape[0]
    if n <= chunk or n % chunk:
        return tuple(score_rows(items))
    parts = [score_rows(it) for it in items.split(chunk)]
    return (torch.cat([p.values for p in parts]),
            torch.cat([p.indices for p in parts]))


def _batch_abs(cfg, batch):
    return {k: sds((batch, n), torch.int32) for k, n in (
        ("items", cfg.seq_len), ("mask_pos", cfg.n_masked),
        ("mask_labels", cfg.n_masked))}


SPEC = make_recsys_arch(
    "bert4rec",
    full_cfg_fn=full, smoke_cfg_fn=smoke,
    init_fn=R.bert4rec_init, model_fn=R.Bert4Rec, loss_fn=R.bert4rec_loss,
    serve_fn=_serve,
    retrieval_fn=lambda model, user, cand: R.bert4rec_score_candidates(
        model, user["items"], cand),
    batch_abs_fn=_batch_abs,
    user_abs_fn=lambda cfg: {"items": sds((1, cfg.seq_len), torch.int32)},
    cand_abs_fn=cand_ids_abs,
)
