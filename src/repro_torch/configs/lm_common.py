"""LM-family cells: train_4k / prefill_32k / decode_32k / long_500k; the
counterpart of ``repro.configs.lm_common`` on one card.

Shape semantics (per assignment):
  train_4k    — train_step, seq 4096, global batch 256
  prefill_32k — serve_prefill, seq 32768, global batch 32
  decode_32k  — serve_step: ONE new token, KV cache of 32768, batch 128
  long_500k   — serve_step: ONE token, 524288-entry KV cache, batch 1

JAX shards the parameters (FSDP × TP), the activations over (pod, data) and
the decode caches over (batch, seq); the port has no mesh yet, so a cell's
arguments are whole tensors on one device.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.configs import common
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


def build_lm_cell(cfg: T.TransformerConfig, shape_name: str,
                  opt_cfg: AdamWConfig, shapes=None,
                  arch_name: str = "lm") -> common.CellSpec:
    info = (shapes or LM_SHAPES)[shape_name]
    seq, batch, entry = info["seq_len"], info["global_batch"], info["entry"]
    name = f"{arch_name}/{shape_name}"
    params = functools.partial(common.abstract_params, T.Transformer, cfg)

    if entry == "train":
        step = common.make_train_step(T.loss_fn, opt_cfg)

        def abstract_args():
            p_abs = params()
            return (p_abs, common.abstract_opt_state(opt_cfg, p_abs),
                    {"tokens": common.sds((batch, seq), _INT),
                     "labels": common.sds((batch, seq), _INT)})

        return common.CellSpec(name=name, entry="train", fn=step,
                               abstract_args=abstract_args,
                               tokens=batch * seq)

    if entry == "prefill":
        def prefill_fn(params, tokens, max_seq=None):
            """JAX's ``prefill(params, tokens, cfg)``; ``max_seq`` leaves
            room in the cache for decode steps (default: the prompt's
            length, JAX's)."""
            return T.prefill(params, tokens, max_seq=max_seq)

        return common.CellSpec(
            name=name, entry="prefill", fn=prefill_fn,
            abstract_args=lambda: (params(), common.sds((batch, seq), _INT)),
            tokens=batch * seq)

    # decode: one token against a `seq`-deep cache
    def decode_fn(params, tokens, cache):
        return T.decode_step(params, tokens, cache)

    def abstract_args():
        cache = T.init_cache(cfg, batch, seq, length=seq - 1,
                             device=common.META)
        return (params(), common.sds((batch, 1), _INT), cache)

    return common.CellSpec(name=name, entry="decode", fn=decode_fn,
                           abstract_args=abstract_args, tokens=batch)


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
