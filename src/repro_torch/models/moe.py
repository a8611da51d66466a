"""Mixture-of-Experts FFN with grouped sort-based capacity dispatch, the
counterpart of ``repro.models.moe``.

Token-choice top-k routing, JAX's semantics step for step: the tokens split
into G dispatch groups (32 when T is a multiple of 32 and T >= 32, else 1);
in each group the (token, slot) assignments are stably sorted by expert,
ranked inside their expert by ``searchsorted(side="left")``, and dropped at
rank >= C (:func:`capacity`); the kept ones fill an (E, G·C, d) buffer, the
three expert products run over every expert at once (``torch.bmm``; the
JAX package runs them as einsums, not as a Pallas kernel), and each token
sums its slots' outputs weighted by the renormalised router probability.
Aux losses: Switch load balancing on the top-1 expert, and the router
z-loss.

Three choices make the card's run match the CPU's and itself:

* **Ties break to the lower expert id**, as ``jax.lax.top_k`` does: the
  top-k is a stable descending sort of the probabilities (``torch.topk``
  states no order for ties; a zero row, uniform after the softmax, is a
  full tie).
* **No host sync**: every shape is static (the capacity is a Python int
  from the shapes), a dropped assignment is written to a spare row of its
  own past the buffer instead of being masked out, and no op reads a value
  back.
* **A fixed order of adds**: the dispatch is a plain assignment (every
  assignment has a row of its own, so no two writes meet), and the combine
  gathers each token's K outputs into (T, K, d) and sums them, weighted
  (0 where dropped), in one (1, K) @ (K, d) product a token, where a
  scatter-add on the card would add in no fixed order. So two calls are
  bit-equal, and so are their gradients.

The groups run as one batch: the sort runs along the last axis of
(G, Tg·K) and ``torch.searchsorted`` is batched. JAX's
``constrain_moe_buf`` is a sharding hint and is left out.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers


class MoEConfig(NamedTuple):
    n_experts: int
    top_k: int
    d_model: int
    d_ff: int  # per-expert
    n_shared: int = 0  # always-on shared experts (DeepSeek-V3 style)
    capacity_factor: float = 1.25
    n_groups: int = 32  # dispatch groups
    dtype: torch.dtype = torch.float32


class MoEOut(NamedTuple):
    y: torch.Tensor
    aux_loss: torch.Tensor
    z_loss: torch.Tensor


def capacity(cfg: MoEConfig, n_tokens: int) -> int:
    """Slots per expert in a group of ``n_tokens``: the capacity factor's
    share, rounded up to a multiple of 8, at least 8."""
    c = int(cfg.capacity_factor * cfg.top_k * n_tokens / cfg.n_experts)
    return max(8, -(-c // 8) * 8)


def n_groups(cfg: MoEConfig, n_tokens: int) -> int:
    """JAX's group rule: ``cfg.n_groups`` when it divides the tokens and
    they are at least as many, else one group."""
    g = cfg.n_groups
    return g if n_tokens % g == 0 and n_tokens >= g else 1


class MoE(nn.Module):
    """One MoE FFN's weights (uninitialised; see :func:`init_moe`; run by
    :func:`moe_ffn`), named as JAX's pytree: ``router`` (d, E) always f32, ``w_gate`` / ``w_up``
    (E, d, f), ``w_down`` (E, f, d), and ``shared`` (a SwiGLU of width
    f·n_shared) when ``cfg.n_shared``."""

    def __init__(self, cfg: MoEConfig, device):
        super().__init__()
        e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
        mk = lambda shape, dt: nn.Parameter(torch.empty(shape, dtype=dt,
                                                        device=device))
        self.cfg = cfg
        self.router = mk((d, e), torch.float32)
        self.w_gate = mk((e, d, f), cfg.dtype)
        self.w_up = mk((e, d, f), cfg.dtype)
        self.w_down = mk((e, f, d), cfg.dtype)
        self.shared = (layers.SwiGLU(d, f * cfg.n_shared, cfg.dtype, device)
                       if cfg.n_shared else None)


@torch.no_grad()
def fill_moe(generator: torch.Generator, module: MoE) -> MoE:
    """Draw ``module``'s weights in place with JAX's distributions: the
    router normal·1/sqrt(d) in f32, each expert's gate and up normal·
    1/sqrt(d) and down normal·1/sqrt(f), drawn in f32 one expert at a time
    (DeepSeek-V3's (256, 7168, 2048) tensors never exist in f32), the
    shared SwiGLU as ``layers.init_swiglu``."""
    cfg = module.cfg
    module.router.copy_(layers.dense_init(generator, cfg.d_model,
                                          cfg.n_experts, torch.float32))
    for w in (module.w_gate, module.w_up, module.w_down):
        for slab in w:
            slab.copy_(layers.dense_init(generator, *slab.shape, cfg.dtype))
    if module.shared is not None:
        for w in (module.shared.w_gate, module.shared.w_up,
                  module.shared.w_down):
            w.copy_(layers.dense_init(generator, *w.shape, cfg.dtype))
    return module


def init_moe(generator: torch.Generator, cfg: MoEConfig,
             device=None) -> MoE:
    """A :class:`MoE` on ``device`` (the generator's by default) drawn by
    :func:`fill_moe`. JAX's distributions; not JAX's bits."""
    dev = generator.device if device is None else torch.device(device)
    return fill_moe(generator, MoE(cfg, dev))


def route(router: torch.Tensor, xg: torch.Tensor, top_k: int):
    """(logits, probs, top_p, top_e) of tokens ``xg`` (..., d): f32 router
    logits and softmax, the top-k probabilities and expert ids (ties to the
    lower id, as ``jax.lax.top_k``), the probabilities renormalised by
    ``max(sum, 1e-9)``."""
    logits = xg.float() @ router
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., :top_k], top_e[..., :top_k]
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
    return logits, probs, top_p, top_e


def slots(top_e: torch.Tensor, n_experts: int, cap: int) -> torch.Tensor:
    """(G, Tg, K) expert ids -> (G, Tg, K) buffer rows: assignment (t, k)
    of group g at rank r inside expert e goes to row ``e·G·C + g·C + r``
    when r < C; a dropped one (r >= C) to a spare row of its own past the
    buffer, ``E·G·C + (g·Tg + t)·K + k``. The rank is JAX's: a stable sort
    of the group's flattened assignments by expert, then the position past
    ``searchsorted(side="left")`` of the expert."""
    g, tg, k = top_e.shape
    flat_e = top_e.reshape(g, tg * k)
    se, order = torch.sort(flat_e, dim=-1, stable=True)
    experts = torch.arange(n_experts, device=top_e.device,
                           dtype=se.dtype).expand(g, n_experts).contiguous()
    starts = torch.searchsorted(se, experts, side="left")
    pos_sorted = (torch.arange(tg * k, device=top_e.device)
                  - starts.gather(1, se))
    pos = torch.empty_like(pos_sorted).scatter_(1, order, pos_sorted)
    group = torch.arange(g, device=top_e.device)[:, None]
    row = flat_e * (g * cap) + group * cap + pos
    spare = n_experts * g * cap + torch.arange(
        g * tg * k, device=top_e.device).view(g, tg * k)
    return torch.where(pos < cap, row, spare).view(g, tg, k)


def plan(router: torch.Tensor, xt: torch.Tensor, cfg: MoEConfig, g: int,
         cap: int):
    """Route tokens ``xt`` (T, d) in ``g`` contiguous groups of capacity
    ``cap``: (logits, probs, top_p, top_e) of :func:`route` and each (token,
    slot) assignment's buffer row (T·K,), token-major (:func:`slots`)."""
    t, d = xt.shape
    logits, probs, top_p, top_e = route(router, xt.reshape(g, t // g, d),
                                        cfg.top_k)
    row = slots(top_e, cfg.n_experts, cap).reshape(-1)
    return logits, probs, top_p, top_e, row


def dispatch(xt: torch.Tensor, row: torch.Tensor, n_experts: int,
             rows: int) -> torch.Tensor:
    """The (E, rows / E, d) expert-major buffer: each assignment's token
    copied to its row, the dropped ones past the buffer, which is cut
    off."""
    t, d = xt.shape
    k = row.numel() // t
    buf = xt.new_zeros(rows + t * k, d).index_copy(
        0, row, xt[:, None].expand(t, k, d).reshape(t * k, d))
    return buf[:rows].view(n_experts, rows // n_experts, d)


def experts(buf: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
            w_down: torch.Tensor) -> torch.Tensor:
    """The three expert products over every row of the buffer (``bmm``)."""
    gate = torch.bmm(buf, w_gate)
    up = torch.bmm(buf, w_up)
    h = F.silu(gate.float()).to(buf.dtype) * up
    return torch.bmm(h, w_down)


def combine(out: torch.Tensor, row: torch.Tensor,
            top_p: torch.Tensor) -> torch.Tensor:
    """(T, d): each token's K outputs of ``out`` (E, ·, d) (a dropped one
    reads some row, at weight 0), weighted by the renormalised
    probabilities and summed over K in one (1, K) @ (K, d) product."""
    d = out.shape[-1]
    out = out.reshape(-1, d)
    rows = out.shape[0]
    k = top_p.shape[-1]
    t = row.numel() // k
    w = torch.where(row < rows, top_p.reshape(-1), 0.0).to(out.dtype)
    got = out.index_select(0, row % rows).view(t, k, d)
    return torch.bmm(w.view(t, 1, k), got).view(t, d)


def row_layout(cfg: MoEConfig, n_tokens: int, n_rows: int):
    """(groups a data row, capacity) of the global batch's routing layout
    when its ``n_tokens`` tokens (flattened in (batch, seq) order) lie in
    ``n_rows`` equal contiguous rows: the groups are
    ``n_groups(cfg, n_tokens)`` chunks of the global order, the capacity
    that of the global group size. A row must hold whole groups, else
    ``ValueError``."""
    g = n_groups(cfg, n_tokens)
    tg = n_tokens // g
    if n_tokens % n_rows or (n_tokens // n_rows) % tg:
        raise ValueError(
            f"the MoE's {g} groups of {tg} tokens do not split over "
            f"{n_rows} data rows of {n_tokens / n_rows:g} tokens: a row must "
            "hold whole groups")
    return (n_tokens // n_rows) // tg, capacity(cfg, tg)


def aux_terms(logits: torch.Tensor, probs: torch.Tensor,
              top_e: torch.Tensor):
    """One row's share of the aux and z losses: its top-1 counts per
    expert (no gradient), its router probabilities summed per expert and
    its tokens' squared log-sum-exp summed (both with their gradient)."""
    e = probs.shape[-1]
    top1 = top_e[..., 0].reshape(-1, 1)
    counts = (top1 == torch.arange(e, device=top1.device)).float().sum(0)
    return (counts, probs.reshape(-1, e).sum(0),
            torch.logsumexp(logits, dim=-1).square().sum())


def aux_from_rows(terms, n_tokens: int):
    """(aux, z) over the rows' :func:`aux_terms`, summed in row order:
    ``E · Σ_e frac_tok_e · frac_prob_e`` and the mean squared
    log-sum-exp, over all ``n_tokens`` tokens."""
    dev = terms[0][0].device
    counts, prob, lse = (sum(t[i].to(dev) for t in terms) for i in range(3))
    e = counts.numel()
    aux = e * ((counts / n_tokens) * (prob / n_tokens)).sum()
    return aux, lse / n_tokens


def moe_ffn(module: MoE, x: torch.Tensor, cfg: MoEConfig) -> MoEOut:
    """x: (..., d_model) -> MoEOut(y of x's shape and dtype, f32 aux, f32
    z). Flattens the leading dims to T tokens, as JAX's ``moe_ffn``."""
    lead, d = x.shape[:-1], x.shape[-1]
    xt = x.reshape(-1, d)
    t = xt.shape[0]
    e = cfg.n_experts
    g = n_groups(cfg, t)
    c = capacity(cfg, t // g)

    logits, probs, top_p, top_e, row = plan(module.router, xt, cfg, g, c)
    out = experts(dispatch(xt, row, e, e * g * c), module.w_gate,
                  module.w_up, module.w_down)
    y = combine(out, row, top_p)
    if module.shared is not None:
        y = y + module.shared(xt)
    aux, z = aux_from_rows([aux_terms(logits, probs, top_e)], t)
    return MoEOut(y=y.view(*lead, d), aux_loss=aux, z_loss=z)
