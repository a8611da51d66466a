"""Gradient compression: top-k sparsification with error feedback, the
counterpart of ``repro.train.compression`` (Deep Gradient Compression).

Only the largest-|g| fraction of each leaf is kept; the residual is
accumulated locally and folded into the next step, so the method converges
to the dense optimum. The returned gradients are dense-shaped (zeros
elsewhere). Trees are flat ``dict[str, Tensor]``.

:func:`quantized_psum` is the int8 all-reduce. Where JAX's runs inside
``shard_map`` over an ``axis_name``, the port's takes every shard's tree,
in shard order, and returns one tree a shard.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.train.optimizer import QBLOCK, _pad_last, named


def init_error_feedback(params) -> dict[str, torch.Tensor]:
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in named(params).items()}


def topk_sparsify(grads, ef, k_frac: float = 0.1):
    """Returns (sparse_grads, new_ef, stats). Dense-shaped, zero off-support.

    A leaf keeps every entry whose |g + e| is at least its k-th largest
    (k = max(1, int(k_frac * size)), ties kept), as JAX's mask does."""
    sparse, new_ef = {}, {}
    for n, g in named(grads).items():
        gf = g.float() + ef[n]
        flat = gf.reshape(-1)
        k = max(1, int(k_frac * flat.shape[0]))
        thresh = torch.topk(flat.abs(), k).values[-1]
        sp = gf * (gf.abs() >= thresh).float()
        sparse[n] = sp.to(g.dtype)
        new_ef[n] = gf - sp
    return sparse, new_ef, {"k_frac": k_frac}


def _qpsum_leaf(gs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    dev = gs[0].device
    orig = gs[0].shape[-1]
    blocks = []
    for g in gs:
        gp = _pad_last(g.float(), QBLOCK)
        blocks.append(gp.reshape(*gp.shape[:-1], -1, QBLOCK))
    # the shared scale: each shard's block absmax / 127, the max over shards.
    # The divisor is a tensor on the block's device: CUDA divides by a host
    # scalar through its reciprocal, which rounds otherwise than a division
    scale = None
    for b in blocks:
        d127 = torch.tensor(127.0, device=b.device)
        local = (b.abs().amax(-1, keepdim=True) / d127).to(dev)
        scale = local if scale is None else torch.maximum(scale, local)
    total = None
    for b in blocks:  # int32 sum in shard order
        q = torch.round(b / scale.to(b.device).clamp(min=1e-12))
        q = q.clamp(-127, 127).to(torch.int32).to(dev)
        total = q if total is None else total + q
    out = (total.float() * scale).reshape(*blocks[0].shape[:-2], -1)
    return [out[..., :orig].to(g.dtype).to(g.device) for g in gs]


def quantized_psum(trees: Sequence) -> list[dict[str, torch.Tensor]]:
    """int8 all-reduce over the shards' trees: each block of 128 along the
    last axis takes the shared scale (the max over shards of its absmax,
    / 127), every shard's values are rounded against it (half to even, as
    ``jnp.round``) and clipped to ±127, the integers summed in int32 in
    shard order, and the sum dequantized. Exact integer summation; the
    error an element is at most S · scale / 2 for S shards. Returns one
    tree a shard, each on its shard's devices (JAX's ``psum`` replicates
    the sum)."""
    trees = [named(t) for t in trees]
    outs = [{} for _ in trees]
    for name in trees[0]:
        for out, y in zip(outs, _qpsum_leaf([t[name] for t in trees])):
            out[name] = y
    return outs
