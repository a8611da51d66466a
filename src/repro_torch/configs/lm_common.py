"""LM-family cells: train_4k / prefill_32k / decode_32k / long_500k; the
counterpart of ``repro.configs.lm_common``.

Shape semantics (per assignment):
  train_4k    — train_step, seq 4096, global batch 256
  prefill_32k — serve_prefill, seq 32768, global batch 32
  decode_32k  — serve_step: ONE new token, KV cache of 32768, batch 128
  long_500k   — serve_step: ONE token, 524288-entry KV cache, batch 1

Sharding, JAX's: params FSDP×TP (ZeRO-3), activations batch-sharded over
(pod, data); decode caches sharded (batch → dp, seq → model), except where
the batch does not split over dp (long_500k's batch of 1), where seq goes
over (data, model). The train cell runs on a mesh, its products
tensor-parallel on "model" (``distributed/tensor_parallel.py``); the
prefill and decode cells give their specs on a mesh, and their ``fn``
takes whole tensors on one device: running a cache sharded over the
sequence is a later item.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.configs import common
from repro_torch.distributed import sharding as shr
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models import transformer as T
from repro_torch.train.optimizer import AdamWConfig

LM_SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, entry="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, entry="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, entry="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, entry="decode"),
}

SMOKE_SHAPES = {
    "train_4k": dict(seq_len=64, global_batch=4, entry="train"),
    "prefill_32k": dict(seq_len=128, global_batch=2, entry="prefill"),
    "decode_32k": dict(seq_len=128, global_batch=4, entry="decode"),
    "long_500k": dict(seq_len=256, global_batch=1, entry="decode"),
}

_INT = torch.int32


def _dp(mesh):
    return shr.batch_axes(mesh)


def _params_shardings(cfg, mesh):
    p_abs = common.abstract_params(T.Transformer, cfg)
    fsdp = _dp(mesh) if shr.ZERO_STAGE >= 3 else ()
    return p_abs, shr.lm_param_specs(p_abs, mesh, fsdp=fsdp)


def _opt_base_shardings(cfg, mesh, p_abs):
    """Optimizer states are always fully sharded (ZeRO-1 keeps master/m/v
    on the fsdp axes even when the working params are TP-only)."""
    return shr.lm_param_specs(p_abs, mesh, fsdp=_dp(mesh))


def _batch_spec(mesh, batch: int):
    dp = _dp(mesh)
    total = math.prod(mesh.shape[a] for a in dp)
    return shr.P(dp if batch % total == 0 else None, None)


def _cache_specs(cfg: T.TransformerConfig, mesh, batch: int) -> T.KVCache:
    """KVCache sharding: batch -> dp, seq -> model; if batch==1, seq ->
    (data, model) so a 512k cache fits (the SP decode path)."""
    dp = _dp(mesh)
    total_dp = math.prod(mesh.shape[a] for a in dp)
    if batch == 1 or batch % total_dp:
        bspec, sspec = None, ("data", "model")
    else:
        bspec, sspec = dp, "model"
    if cfg.mla:
        kv = shr.P(None, bspec, sspec, None)
    else:
        kv = shr.P(None, bspec, sspec, None, None)
    return T.KVCache(k=kv, v=kv, length=shr.P())


def _whole(*args) -> None:
    """Prefill and decode take whole tensors: a placed argument raises."""
    if any(isinstance(a, shr.Placed) for a in args):
        raise NotImplementedError(
            "prefill and decode run on whole tensors on one device; a cache "
            "sharded over the sequence is not ported yet")


def build_lm_cell(cfg: T.TransformerConfig, shape_name: str,
                  opt_cfg: AdamWConfig, shapes=None,
                  arch_name: str = "lm") -> common.CellSpec:
    info = (shapes or LM_SHAPES)[shape_name]
    seq, batch, entry = info["seq_len"], info["global_batch"], info["entry"]
    name = f"{arch_name}/{shape_name}"
    params = functools.partial(common.abstract_params, T.Transformer, cfg)

    if entry == "train":
        holder: dict = {}
        step = common.make_train_step(T.loss_fn, opt_cfg,
                                      grad_specs_holder=holder)

        def abstract_args(mesh=None):
            if mesh is None:
                p_abs = params()
                return (p_abs, common.abstract_opt_state(opt_cfg, p_abs),
                        {"tokens": common.sds((batch, seq), _INT),
                         "labels": common.sds((batch, seq), _INT)})
            p_abs, p_specs = _params_shardings(cfg, mesh)
            o_abs = common.abstract_opt_state(opt_cfg, p_abs)
            opt_base = _opt_base_shardings(cfg, mesh, p_abs)
            o_specs = shr.opt_state_specs(opt_base, o_abs, p_abs)
            # grads live where the opt shards live; the step runs the
            # module's layers on the weights' blocks
            holder.update(mesh=mesh, specs=opt_base, model=p_abs,
                          blocks_loss=tp.lm_loss_and_grads)
            bspec = _batch_spec(mesh, batch)
            return (common.with_shardings(p_abs, p_specs, mesh),
                    common.with_shardings(o_abs, o_specs, mesh),
                    {"tokens": common.sds((batch, seq), _INT, mesh, bspec),
                     "labels": common.sds((batch, seq), _INT, mesh, bspec)})

        return common.CellSpec(
            name=name, entry="train", fn=step, abstract_args=abstract_args,
            tokens=batch * seq,
            out_shardings=lambda args: (common.arg_shardings(args[0]),
                                        common.arg_shardings(args[1]), None))

    if entry == "prefill":
        def prefill_fn(params, tokens, max_seq=None):
            """JAX's ``prefill(params, tokens, cfg)``; ``max_seq`` leaves
            room in the cache for decode steps (default: the prompt's
            length, JAX's)."""
            _whole(tokens)
            return T.prefill(params, tokens, max_seq=max_seq)

        def abstract_args(mesh=None):
            if mesh is None:
                return params(), common.sds((batch, seq), _INT)
            p_abs, p_specs = _params_shardings(cfg, mesh)
            return (common.with_shardings(p_abs, p_specs, mesh),
                    common.sds((batch, seq), _INT, mesh,
                               _batch_spec(mesh, batch)))

        return common.CellSpec(name=name, entry="prefill", fn=prefill_fn,
                               abstract_args=abstract_args,
                               tokens=batch * seq)

    # decode: one token against a `seq`-deep cache
    def decode_fn(params, tokens, cache):
        _whole(tokens, *cache)
        return T.decode_step(params, tokens, cache)

    def abstract_args(mesh=None):
        cache = T.init_cache(cfg, batch, seq, length=seq - 1,
                             device=common.META)
        if mesh is None:
            return (params(), common.sds((batch, 1), _INT), cache)
        p_abs, p_specs = _params_shardings(cfg, mesh)
        c_specs = _cache_specs(cfg, mesh, batch)
        return (common.with_shardings(p_abs, p_specs, mesh),
                common.sds((batch, 1), _INT, mesh, _batch_spec(mesh, batch)),
                common.with_shardings(cache, c_specs, mesh))

    return common.CellSpec(
        name=name, entry="decode", fn=decode_fn, abstract_args=abstract_args,
        tokens=batch,
        out_shardings=lambda args: (None, common.arg_shardings(args[2])))


def make_lm_arch(name: str, full_cfg_fn, smoke_cfg_fn,
                 opt_cfg: AdamWConfig | None = None) -> common.ArchSpec:
    opt_cfg = opt_cfg or AdamWConfig()

    def build(cfg, shape, smoke=False):
        return build_lm_cell(cfg, shape, opt_cfg,
                             shapes=SMOKE_SHAPES if smoke else LM_SHAPES,
                             arch_name=name)

    return common.ArchSpec(
        name=name,
        family="lm",
        make_config=lambda smoke=False: smoke_cfg_fn() if smoke else full_cfg_fn(),
        shapes=LM_SHAPES,
        build_cell=build,
        init_params=T.init_params,
        model=T.Transformer,
    )
