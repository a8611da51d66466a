"""Gradient compression: top-k sparsification with error feedback, the
counterpart of ``repro.train.compression`` (Deep Gradient Compression).

Only the largest-|g| fraction of each leaf is kept; the residual is
accumulated locally and folded into the next step, so the method converges
to the dense optimum. The returned gradients are dense-shaped (zeros
elsewhere). Trees are flat ``dict[str, Tensor]``. Not here yet:
``quantized_psum`` (the int8 all-reduce), which needs the data-parallel
trainer.
"""
from __future__ import annotations

import torch

from repro_torch.train.optimizer import named


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
