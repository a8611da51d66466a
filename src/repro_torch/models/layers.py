"""Shared neural-net layers, the counterparts of ``repro.models.layers``.

Plain functions on tensors, in the JAX package's layouts: activations are
(B, S, d), attention heads (B, S, H, dh), weights (d_in, d_out) so that
``x @ w`` is the same product. Initialisers draw from an explicit
``torch.Generator`` on the device the weights live on. Normalisation
statistics, RoPE angles and the softmax run in float32, as in JAX.

Attention goes through the port's hand-written ``flash_attention`` kernel on
a CUDA tensor (the tensor-core route for bf16/f16, the SIMT route for f32;
under grad its backward is the hand-written ``flash_attention_bwd``) and
through its plain version on a CPU tensor; single-token decode goes through
the hand-written ``flash_decode`` the same way, reading the grouped cache as
it lies. ``layer_norm`` and ``mlp`` serve the recommender models
(``models/recsys.py``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.flash_attention import flash_attention, flash_decode


# --------------------------------------------------------------------------
# init helpers
# --------------------------------------------------------------------------
def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype) -> torch.Tensor:
    """(d_in, d_out) normals scaled by 1/sqrt(d_in), drawn in f32 on the
    generator's device, then cast."""
    w = torch.randn((d_in, d_out), generator=generator,
                    device=generator.device)
    return w.mul_(1.0 / math.sqrt(d_in)).to(dtype)


def embed_init(generator: torch.Generator, vocab: int, dim: int,
               dtype: torch.dtype) -> torch.Tensor:
    """(vocab, dim) normals scaled by 0.02, drawn in f32, then cast."""
    w = torch.randn((vocab, dim), generator=generator, device=generator.device)
    return w.mul_(0.02).to(dtype)


# --------------------------------------------------------------------------
# normalization
# --------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * gamma.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """JAX's ``layer_norm``: f32 statistics with the population variance
    and eps 1e-6 (not torch's 1e-5), ``out * gamma + beta`` in f32, then
    cast back to x's dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * gamma.float() + beta.float()).to(x.dtype)


# --------------------------------------------------------------------------
# rotary position embeddings
# --------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(theta, exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, n_heads, head_dim); positions: (..., S) integers.

    Split-half rotation (not interleaved); the angles are f32
    ``positions * freqs``."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)
    angles = positions[..., None].float() * freqs  # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------
def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, Hkv, dh) -> (B, S, Hkv*n_rep, dh) for GQA/MQA."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def heads_first(x: torch.Tensor, n_rep: int = 1) -> torch.Tensor:
    """(B, S, Hkv, d) -> contiguous (B, Hkv*n_rep, S, d), in one copy: the
    kernel's layout, with each head repeated as ``repeat_kv`` orders them."""
    b, s, h, d = x.shape
    return x.transpose(1, 2)[:, :, None].expand(b, h, n_rep, s, d).reshape(
        b, h * n_rep, s, d).contiguous()


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, block_kv: int = 512,
                        scale: float | None = None,
                        q_offset: int = 0) -> torch.Tensor:
    """Grouped attention. q: (B, Sq, H, dh); k, v: (B, Skv, Hkv, dh|dv) with
    H = Hkv·rep -> (B, Sq, H, dv) in q's dtype.

    Runs ``kernels.flash_attention.flash_attention``: its kernel on a CUDA
    tensor, its plain version on a CPU tensor. The kernel takes H heads of
    k and v in (B, H, S, d) layout, so every operand is copied once into
    that layout (``heads_first``), GQA k/v repeated to H heads on the way.
    Differentiable: the gradient of a repeated k/v head is summed back over
    its ``rep`` copies by autograd through ``heads_first``'s ``expand``,
    which is JAX's gradient (its einsums never materialise the repeat).

    The kernel places the queries at the end of the KV window (query i at
    ``Skv - Sq + i``). That is JAX's mask when ``q_offset == Skv - Sq``,
    which holds for every caller (``q_offset = 0``, ``Sq = Skv``); any
    other ``q_offset`` with ``causal`` raises ``ValueError``. ``q_offset``
    is ignored when not ``causal``, as in JAX. ``block_kv`` is JAX's
    memory knob for its scan over KV blocks; it is accepted and changes
    nothing here.
    """
    del block_kv
    b, sq, h, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if causal and q_offset != skv - sq:
        raise ValueError(
            f"blockwise_attention: causal with q_offset={q_offset}; the "
            f"kernel places the queries at Skv - Sq = {skv - sq}")
    if h % hkv:
        raise ValueError(f"blockwise_attention: {h} query heads over {hkv} "
                         "kv heads")
    rep = h // hkv
    out = flash_attention(heads_first(q), heads_first(k, rep),
                          heads_first(v, rep), causal=causal, sm_scale=scale)
    return out.transpose(1, 2)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, *, length,
                     scale: float | None = None) -> torch.Tensor:
    """Single-token grouped attention against a KV cache. q: (B, 1, H, dh);
    caches (B, S, Hkv, dh|dv) with H = Hkv·rep -> (B, 1, H, dv) in q's dtype.

    Runs ``kernels.flash_attention.flash_decode``: its kernel on a CUDA
    tensor, its plain version (JAX's grouped einsum) on a CPU tensor. The
    cache is read as it lies, never repeated to H heads. ``length`` (an int,
    or a 0-d or (B,) integer tensor on q's device, which stays there) is the
    valid prefix of each row's cache. A row of length 0 comes out 0, where
    JAX's einsum gives NaN; ``decode_step`` always passes ``length + 1``.
    """
    b, _, h, _ = q.shape
    out = flash_decode(q[:, 0], k_cache, v_cache, length=length,
                       sm_scale=scale)
    return out.view(b, 1, h, out.shape[-1])


# --------------------------------------------------------------------------
# FFN
# --------------------------------------------------------------------------
def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = x @ w_gate
    u = x @ w_up
    return (F.silu(g.float()).to(x.dtype) * u) @ w_down


class SwiGLU(nn.Module):
    """The weights of one SwiGLU FFN (uninitialised; see :func:`init_swiglu`)."""

    def __init__(self, d_model: int, d_ff: int, dtype: torch.dtype, device):
        super().__init__()
        mk = lambda *shape: nn.Parameter(torch.empty(shape, dtype=dtype,
                                                     device=device))
        self.w_gate = mk(d_model, d_ff)
        self.w_up = mk(d_model, d_ff)
        self.w_down = mk(d_ff, d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return swiglu(x, self.w_gate, self.w_up, self.w_down)


def init_swiglu(generator: torch.Generator, d_model: int, d_ff: int,
                dtype: torch.dtype) -> SwiGLU:
    ffn = SwiGLU(d_model, d_ff, dtype, generator.device)
    with torch.no_grad():
        for w in (ffn.w_gate, ffn.w_up, ffn.w_down):
            w.copy_(dense_init(generator, *w.shape, dtype))
    return ffn


def mlp(x: torch.Tensor, ws, bs, act=F.relu) -> torch.Tensor:
    """JAX's plain MLP tower (the recommender heads): ``h @ w + b`` per
    layer (one product with the bias added in it), ``act`` between layers
    only; the last layer stays linear."""
    h = x
    for i, (w, b) in enumerate(zip(ws, bs)):
        h = F.linear(h, w.t(), b)
        if i < len(ws) - 1:
            h = act(h)
    return h
