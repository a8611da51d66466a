"""Optimizers: AdamW with optional int8-quantized moment states, the
counterpart of ``repro.train.optimizer``.

Params, gradients, the f32 master copy and the moments are flat
``dict[str, Tensor]`` (an ``nn.Module`` is read through
``named_parameters()``), in JAX's functional form: ``update`` returns new
tensors and never writes its arguments. Each moment is an f32 tensor, or
with ``quantized_state`` a ``{"q": int8, "scale": f32}`` pair quantized in
blocks of 128 along the last axis with a per-block absmax scale (v stored
as sqrt(v)).

Mixed precision as in JAX: params may be bf16; the optimizer keeps an f32
master copy, decays only tensors with ``ndim >= 2``, and casts back after the
update. Scalars of the schedule (lr, bias corrections) are f32 0-d tensors
on the host, as PyTorch lets them combine with tensors on the card without a
copy or a sync; the clip factor stays on the gradients' device.
"""
from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

QBLOCK = 128

Params = Mapping[str, torch.Tensor]


def named(params: nn.Module | Params) -> dict[str, torch.Tensor]:
    """The flat ``{name: tensor}`` of a module's parameters or a mapping."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


# --------------------------------------------------------------------------
# block quantization helpers (also reused by gradient compression)
# --------------------------------------------------------------------------
def _pad_last(x: torch.Tensor, mult: int) -> torch.Tensor:
    pad = (-x.shape[-1]) % mult
    return F.pad(x, (0, pad)) if pad else x


def quantize_blockwise(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 (..., d) -> (int8 (..., d), f32 scales (..., ceil(d/128))).
    ``torch.round`` rounds half to even, as ``jnp.round``."""
    orig = x.shape[-1]
    xp = _pad_last(x.float(), QBLOCK)
    blocks = xp.reshape(*xp.shape[:-1], -1, QBLOCK)
    scale = blocks.abs().amax(-1) / 127.0  # (..., nb)
    q = torch.round(blocks / scale[..., None].clamp(min=1e-12))
    q = q.clamp(-127, 127).to(torch.int8)
    return q.reshape(*xp.shape[:-1], -1)[..., :orig].contiguous(), scale


def dequantize_blockwise(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    orig = q.shape[-1]
    qp = _pad_last(q.float(), QBLOCK)
    blocks = qp.reshape(*qp.shape[:-1], -1, QBLOCK)
    x = blocks * scale[..., None]
    return x.reshape(*qp.shape[:-1], -1)[..., :orig]


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    quantized_state: bool = False  # int8 moments
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_frac; an f32 0-d tensor on the
    host (``step`` an int or a tensor)."""
    s = torch.as_tensor(step).detach().cpu().to(torch.float32)
    warm = s / max(cfg.warmup_steps, 1)
    prog = ((s - cfg.warmup_steps)
            / max(cfg.total_steps - cfg.warmup_steps, 1)).clamp(0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.minimum(warm, cos)


class AdamWState(NamedTuple):
    step: int
    master: dict  # f32 master weights
    m: dict | None  # f32, or {"q": int8, "scale": f32} when quantized
    v: dict | None


def _zeros_moment(p: torch.Tensor, quantized: bool):
    zeros = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return _write_moment(zeros, quantized)


def _read_moment(mm, quantized: bool) -> torch.Tensor:
    return dequantize_blockwise(mm["q"], mm["scale"]) if quantized else mm


def _write_moment(x: torch.Tensor, quantized: bool):
    if quantized:
        q, s = quantize_blockwise(x)
        return {"q": q, "scale": s}
    return x


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tree.values()))


def _f32_pow(base: float, step: int) -> torch.Tensor:
    return torch.tensor(base, dtype=torch.float32) ** torch.tensor(
        float(step), dtype=torch.float32)


def make_adamw(cfg: AdamWConfig):
    """``(init, update)``: ``init(params) -> AdamWState``;
    ``update(grads, state, params) -> (new params, new state, {"grad_norm",
    "lr"})``, params and grads flat dicts (or a module's parameters)."""

    def init(params) -> AdamWState:
        params = named(params)
        master = {n: p.detach().to(torch.float32, copy=True)
                  for n, p in params.items()}
        m = {n: _zeros_moment(p, cfg.quantized_state)
             for n, p in params.items()}
        v = {n: _zeros_moment(p, cfg.quantized_state)
             for n, p in params.items()}
        return AdamWState(step=0, master=master, m=m, v=v)

    def update(grads, state: AdamWState, params):
        params, grads = named(params), named(grads)
        step = state.step + 1
        lr = lr_schedule(cfg, step)
        gn = global_norm(grads)
        clip = (cfg.grad_clip / gn.clamp(min=1e-9)).clamp(max=1.0)
        b1c = 1 - _f32_pow(cfg.b1, step)
        b2c = 1 - _f32_pow(cfg.b2, step)
        is_q = cfg.quantized_state
        out = {}
        with torch.no_grad():
            for n, p in params.items():
                g = grads[n].float() * clip
                master = state.master[n]
                m_f = _read_moment(state.m[n], is_q)
                v_f = _read_moment(state.v[n], is_q)
                if is_q:  # v stored as sqrt(v): halves the dynamic range the
                    v_f = v_f * v_f  # int8 grid has to span
                m_new = cfg.b1 * m_f + (1 - cfg.b1) * g
                v_new = cfg.b2 * v_f + (1 - cfg.b2) * g * g
                upd = (m_new / b1c) / (torch.sqrt(v_new / b2c) + cfg.eps)
                decay = cfg.weight_decay * master if master.ndim >= 2 else 0.0
                master_new = master - lr * (upd + decay)
                v_store = torch.sqrt(v_new) if is_q else v_new
                out[n] = (master_new, _write_moment(m_new, is_q),
                          _write_moment(v_store, is_q),
                          master_new.to(p.dtype))
        new_state = AdamWState(step=step,
                               master={n: o[0] for n, o in out.items()},
                               m={n: o[1] for n, o in out.items()},
                               v={n: o[2] for n, o in out.items()})
        return ({n: o[3] for n, o in out.items()}, new_state,
                {"grad_norm": gn, "lr": lr})

    return init, update


def make_sgd(lr: float = 1e-2):
    """Plain SGD (used by convergence tests for gradient compression)."""

    def init(params) -> AdamWState:
        return AdamWState(step=0, master={
            n: p.detach().to(torch.float32, copy=True)
            for n, p in named(params).items()}, m=None, v=None)

    def update(grads, state: AdamWState, params):
        params, grads = named(params), named(grads)
        with torch.no_grad():
            master = {n: ma - lr * grads[n].float()
                      for n, ma in state.master.items()}
            new = {n: master[n].to(p.dtype) for n, p in params.items()}
        return new, AdamWState(step=state.step + 1, master=master, m=None,
                               v=None), {}

    return init, update
