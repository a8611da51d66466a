"""The recommender family's cells, the counterpart of
``repro.configs.recsys_common`` on one card:

  train_batch    — train_step, batch 65,536
  serve_p99      — pointwise scoring, batch 512 (online)
  serve_bulk     — pointwise scoring, batch 262,144 (offline)
  retrieval_cand — ONE user vs 1,000,000 candidates (broadcast scoring)

JAX row-shards the tables over "model", batch-shards the activations and
pads the candidate sweep to a multiple of 512 so that it shards over every
mesh axis; the port has no mesh yet, so a cell's arguments are whole
tensors on one device and the candidates go unpadded."""
from __future__ import annotations

import functools

import torch

from repro_torch.configs import common
from repro_torch.train.optimizer import AdamWConfig

RS_SHAPES = {
    "train_batch": dict(batch=65536, entry="train"),
    "serve_p99": dict(batch=512, entry="serve"),
    "serve_bulk": dict(batch=262144, entry="serve"),
    "retrieval_cand": dict(batch=1, n_candidates=1_000_000, entry="retrieval"),
}

SMOKE_SHAPES = {
    "train_batch": dict(batch=32, entry="train"),
    "serve_p99": dict(batch=16, entry="serve"),
    "serve_bulk": dict(batch=64, entry="serve"),
    "retrieval_cand": dict(batch=1, n_candidates=256, entry="retrieval"),
}


def make_recsys_arch(
    name: str,
    *,
    full_cfg_fn,
    smoke_cfg_fn,
    init_fn,                      # (key, cfg, device=None) -> model
    model_fn,                     # (cfg, device) -> model, weights not drawn
    loss_fn,                      # (model, batch) -> (loss, metrics)
    serve_fn,                     # (model, batch) -> scores
    retrieval_fn,                 # (model, user_batch, cand) -> scores
    batch_abs_fn,                 # (cfg, batch) -> batch dict of meta tensors
    user_abs_fn,                  # (cfg) -> user-side dict (B=1)
    cand_abs_fn,                  # (cfg, n_cand) -> candidates
    opt_cfg: AdamWConfig | None = None,
) -> common.ArchSpec:
    opt_cfg = opt_cfg or AdamWConfig(weight_decay=0.0)

    def build(cfg, shape_name, smoke=False):
        info = (SMOKE_SHAPES if smoke else RS_SHAPES)[shape_name]
        entry = info["entry"]
        cell = functools.partial(common.CellSpec, name=f"{name}/{shape_name}",
                                 entry=entry)
        params = functools.partial(common.abstract_params, model_fn, cfg)

        if entry == "train":
            batch = info["batch"]

            def abstract_args():
                p_abs = params()
                return (p_abs, common.abstract_opt_state(opt_cfg, p_abs),
                        batch_abs_fn(cfg, batch))

            return cell(fn=common.make_train_step(loss_fn, opt_cfg),
                        abstract_args=abstract_args, tokens=batch)

        if entry == "serve":
            batch = info["batch"]

            def abstract_args():
                b = batch_abs_fn(cfg, batch)
                b.pop("label", None)
                b.pop("mask_labels", None)
                return (params(), b)

            return cell(fn=serve_fn, abstract_args=abstract_args,
                        tokens=batch)

        n_cand = info["n_candidates"]
        return cell(fn=retrieval_fn,
                    abstract_args=lambda: (params(), user_abs_fn(cfg),
                                           cand_abs_fn(cfg, n_cand)),
                    tokens=n_cand)

    return common.ArchSpec(
        name=name,
        family="recsys",
        make_config=lambda smoke=False: smoke_cfg_fn() if smoke else full_cfg_fn(),
        shapes=RS_SHAPES,
        build_cell=build,
        init_params=init_fn,
        model=model_fn,
    )


def cand_ids_abs(cfg, n_cand: int) -> torch.Tensor:
    """The 1-D candidate id vector (JAX shards it over "model")."""
    return common.sds((n_cand,), torch.int32)
