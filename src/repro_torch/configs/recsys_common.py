"""The recommender family's cells, the counterpart of
``repro.configs.recsys_common`` on one card:

  train_batch    — train_step, batch 65,536
  serve_p99      — pointwise scoring, batch 512 (online)
  serve_bulk     — pointwise scoring, batch 262,144 (offline)
  retrieval_cand — ONE user vs 1,000,000 candidates (broadcast scoring)

Embedding tables row-sharded over "model" (they are the memory); MLP heads
small enough to FSDP or replicate; activations batch-sharded over
(pod, data): each cell's ``abstract_args(mesh)`` gives JAX's specs. The
train cell runs on a mesh (each data row through a copy of the model
gathered from the blocks: "model" shards the storage, not the products);
the serve and retrieval cells' ``fn`` take whole tensors on one device,
and the candidates go unpadded (JAX pads them to a multiple
of 512 so that they shard over every mesh axis)."""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.configs import common
from repro_torch.distributed import sharding as shr
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


def _dp_spec(mesh, batch: int):
    dp = shr.batch_axes(mesh)
    total = math.prod(mesh.shape[a] for a in dp)
    return shr.P(dp if batch % total == 0 else None)


def _on_mesh(tree: dict, mesh, first) -> dict:
    """Each leaf of an abstract batch with its first dimension on ``first``
    and the rest replicated (JAX's ``P(bspec[0], None)``)."""
    return {k: common.sds(t.shape, t.dtype, mesh,
                          shr.P(first, *(None,) * (t.ndim - 1)))
            for k, t in tree.items()}


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

        def params_shardings(mesh):
            p_abs = params()
            return p_abs, shr.lm_param_specs(p_abs, mesh,
                                             fsdp=shr.batch_axes(mesh),
                                             stacked=False)

        if entry == "train":
            batch = info["batch"]

            holder: dict = {}

            def abstract_args(mesh=None):
                if mesh is None:
                    p_abs = params()
                    return (p_abs, common.abstract_opt_state(opt_cfg, p_abs),
                            batch_abs_fn(cfg, batch))
                p_abs, p_specs = params_shardings(mesh)
                o_abs = common.abstract_opt_state(opt_cfg, p_abs)
                o_specs = shr.opt_state_specs(p_specs, o_abs, p_abs)
                # the step runs each data row through a copy of the module
                holder.update(mesh=mesh, specs=p_specs, model=p_abs)
                return (common.with_shardings(p_abs, p_specs, mesh),
                        common.with_shardings(o_abs, o_specs, mesh),
                        _on_mesh(batch_abs_fn(cfg, batch), mesh,
                                 _dp_spec(mesh, batch)[0]))

            return cell(fn=common.make_train_step(
                            loss_fn, opt_cfg, grad_specs_holder=holder),
                        abstract_args=abstract_args, tokens=batch,
                        out_shardings=lambda args: (
                            common.arg_shardings(args[0]),
                            common.arg_shardings(args[1]), None))

        if entry == "serve":
            batch = info["batch"]

            def abstract_args(mesh=None):
                b = batch_abs_fn(cfg, batch)
                b.pop("label", None)
                b.pop("mask_labels", None)
                if mesh is None:
                    return (params(), b)
                p_abs, p_specs = params_shardings(mesh)
                return (common.with_shardings(p_abs, p_specs, mesh),
                        _on_mesh(b, mesh, _dp_spec(mesh, batch)[0]))

            return cell(fn=serve_fn, abstract_args=abstract_args,
                        tokens=batch)

        n_cand = info["n_candidates"]

        def abstract_args(mesh=None):
            user, cand = user_abs_fn(cfg), cand_abs_fn(cfg, n_cand)
            if mesh is None:
                return (params(), user, cand)
            p_abs, p_specs = params_shardings(mesh)
            m = mesh.shape["model"]
            return (common.with_shardings(p_abs, p_specs, mesh),
                    _on_mesh(user, mesh, None),
                    common.sds(cand.shape, cand.dtype, mesh, shr.P(
                        "model" if n_cand % m == 0 else None,
                        *(None,) * (cand.ndim - 1))))

        return cell(fn=retrieval_fn, abstract_args=abstract_args,
                    tokens=n_cand, act_axes="all")

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
    """The 1-D candidate id vector (sharded over "model" on a mesh)."""
    return common.sds((n_cand,), torch.int32)
