"""Shared machinery for architecture configs: cells, step builders, specs;
the counterpart of ``repro.configs.common`` in its one-card form.

An *arch* module exposes ``SPEC: ArchSpec``. Each of its shapes defines one
**cell**: a step function plus allocation-free abstract arguments.

PyTorch idiom: JAX's ``ShapeDtypeStruct`` is a tensor on the ``meta``
device (shape and dtype, no storage), and ``jax.eval_shape`` of an
initialiser is the model's module built on ``meta``, its draws skipped
(:func:`abstract_params`). There is no mesh yet: ``abstract_args`` takes no
argument and the arguments carry no sharding; JAX's ``out_shardings``,
``act_axes`` and ``grad_specs_holder`` wait for the multi-device plumbing,
and ``donate`` has no counterpart (the train step writes the new weights
into the module in place, :func:`make_train_step`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch import nn

from repro_torch.train.optimizer import AdamWConfig, make_adamw, named

META = torch.device("meta")


def sds(shape, dtype) -> torch.Tensor:
    """A tensor of ``shape`` and ``dtype`` with no storage (JAX's
    ``ShapeDtypeStruct``)."""
    return torch.empty(shape, dtype=dtype, device=META)


@dataclasses.dataclass
class CellSpec:
    """One (arch × shape) target."""

    name: str  # f"{arch}/{shape}"
    entry: str  # train | prefill | decode | serve | retrieval
    fn: Callable  # the step
    # () -> args of meta tensors (a module on meta for the weights)
    abstract_args: Callable[[], tuple]
    # batch-like dims for MODEL_FLOPS accounting
    tokens: int = 0  # tokens processed per step (LM) / items scored (recsys)


@dataclasses.dataclass
class ArchSpec:
    name: str
    family: str  # lm | gnn | recsys
    make_config: Callable[[bool], Any]  # smoke -> config
    shapes: dict[str, dict]  # shape name -> shape kwargs
    # (config, shape, smoke=False) -> cell; ``smoke`` picks the shape table
    build_cell: Callable[..., CellSpec]
    # (seed or generator, config, device=None) -> the model with its weights
    init_params: Callable[..., nn.Module]
    # (config, device) -> the model's module, weights not drawn
    model: Callable[[Any, Any], nn.Module]

    def cells(self, smoke: bool = False):
        cfg = self.make_config(smoke)
        return {s: self.build_cell(cfg, s, smoke=smoke) for s in self.shapes}


def count_params(abstract) -> int:
    """Elements of a module's parameters or of a ``{name: tensor}`` map."""
    return sum(t.numel() for t in named(abstract).values())


def abstract_params(model_fn: Callable[[Any, Any], nn.Module],
                    cfg) -> nn.Module:
    """``model_fn(cfg, device)`` built on the meta device: every parameter's
    shape and dtype, nothing allocated or drawn (JAX's ``eval_shape`` of
    ``init_params``)."""
    return model_fn(cfg, META)


def make_train_step(loss_fn: Callable, opt_cfg: AdamWConfig):
    """A fused forward, backward and AdamW step: ``(params, opt_state,
    batch) -> (params, opt_state, metrics)``.

    ``params`` is a module (or a ``{name: tensor}`` map of leaves that
    require grad); ``loss_fn(params, batch) -> (loss, metrics)``. The new
    weights are written into ``params`` in place, which is returned, as a
    donated buffer would be; ``opt_state`` is replaced. A parameter the
    loss does not reach (the GAT's bias) gets a zero gradient, as under
    ``jax.grad``."""
    _, opt_update = make_adamw(opt_cfg)

    def train_step(params, opt_state, batch):
        leaves = named(params)
        loss, metrics = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g
                 for (n, p), g in zip(leaves.items(), grads)}
        new, opt_state, stats = opt_update(grads, opt_state, leaves)
        with torch.no_grad():
            for n, p in leaves.items():
                p.copy_(new[n])
        return params, opt_state, {"loss": loss.detach(), **stats}

    return train_step


def abstract_opt_state(opt_cfg: AdamWConfig, params_abs):
    """AdamW's state of ``params_abs`` (on the meta device) on the meta
    device."""
    opt_init, _ = make_adamw(opt_cfg)
    return opt_init(params_abs)
