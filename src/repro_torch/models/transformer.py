"""The dense GQA transformer, the counterpart of ``repro.models.transformer``:
the embedding towers (``embed_pool``), the LM loss (``loss_fn``) and the
decode path (``prefill``, ``decode_step``).

PyTorch idiom: a :class:`Transformer` ``nn.Module`` holds the weights, one
:class:`Block` per layer (not JAX's stacked scan), each weight an
``nn.Parameter`` in JAX's (d_in, d_out) layout so that ``x @ w`` is the same
product and a JAX pytree converts by copying (``convert.
transformer_from_numpy``). :func:`init_params` draws them on the card from a
seeded ``torch.Generator``; pass ``device="cpu"`` for the CPU.

Attention runs in ``layers.blockwise_attention`` (the hand-written
``flash_attention`` kernel on the card, and its backward kernel under
grad); the plain products (``x @ W``) are PyTorch's. ``remat="full"``
recomputes each block in the backward pass
(``torch.utils.checkpoint``), as JAX's ``jax.checkpoint`` per block. JAX's ``constrain_batch`` / ``constrain_seq`` are sharding hints
that do nothing without a mesh, and are left out. Not here yet: MoE, MLA,
the MTP head (their flags raise ``NotImplementedError``).

The decode path keeps JAX's cache layout, (L, B, S, Hkv, dh), and reads it
through the hand-written ``flash_decode`` without repeating it to H heads.
Two deliberate differences make a step the card can run back to back:
``decode_step`` writes the new keys and values into the cache *in place*
(JAX returns a new cache; a functional copy of a 32k cache at every token is
not an option), and the cache's ``length`` stays on the cache's device, so
a step never waits for the host.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.backend import as_tensor, resolve_device
from repro_torch.models import layers


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    qk_norm: bool = False
    rope_theta: float = 1e4
    # MoE
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared: int = 0
    first_dense: int = 0  # leading dense-FFN layers (DeepSeek-V3: 3)
    # MLA
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    mtp: bool = False  # multi-token-prediction auxiliary head
    embed_dim: int = 0  # retrieval-embedding head (0 = none)
    dtype: Any = torch.float32
    remat: str = "none"  # none | full
    block_kv: int = 512
    aux_loss_coef: float = 0.001
    z_loss_coef: float = 1e-4
    mtp_coef: float = 0.3
    capacity_factor: float = 1.25
    # distribution/memory policy of the JAX trainer
    seq_parallel: bool = True  # Megatron SP on the residual stream
    ce_chunk: int = 2048  # sequence-chunked cross entropy (0 = dense)

    @property
    def qk_dim(self) -> int:
        return (self.qk_nope_dim + self.qk_rope_dim) if self.mla else self.head_dim

    @property
    def v_dim(self) -> int:
        return self.v_head_dim if self.mla else self.head_dim


def _check_supported(cfg: TransformerConfig) -> None:
    for flag in ("moe", "mla", "mtp"):
        if getattr(cfg, flag):
            raise NotImplementedError(
                f"{cfg.name}: {flag}=True is not ported yet (dense GQA only)")


# ==========================================================================
# modules
# ==========================================================================
def _weight(shape, cfg: TransformerConfig, device, fill=None) -> nn.Parameter:
    w = torch.empty(shape, dtype=cfg.dtype, device=device)
    return nn.Parameter(w if fill is None else w.fill_(fill))


class Attention(nn.Module):
    """GQA attention with optional qk-norm (JAX ``_attention``, GQA path)."""

    def __init__(self, cfg: TransformerConfig, device):
        super().__init__()
        d, h, hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.cfg = cfg
        self.wq = _weight((d, h * hd), cfg, device)
        self.wk = _weight((d, hk * hd), cfg, device)
        self.wv = _weight((d, hk * hd), cfg, device)
        self.wo = _weight((h * hd, d), cfg, device)
        if cfg.qk_norm:
            self.q_norm = _weight((hd,), cfg, device, fill=1.0)
            self.k_norm = _weight((hd,), cfg, device, fill=1.0)

    def qkv(self, x: torch.Tensor, positions: torch.Tensor):
        """q (B, S, H, dh), k and v (B, S, Hkv, dh) of x (B, S, d): the
        products, qk-norm, then RoPE at ``positions`` on q and k."""
        cfg = self.cfg
        b, s, _ = x.shape
        h, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        q = (x @ self.wq).view(b, s, h, hd)
        k = (x @ self.wk).view(b, s, hk, hd)
        v = (x @ self.wv).view(b, s, hk, hd)
        if cfg.qk_norm:
            q = layers.rms_norm(q, self.q_norm)
            k = layers.rms_norm(k, self.k_norm)
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
        return q, k, v

    def attend(self, q: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor) -> torch.Tensor:
        """Causal grouped attention over the whole sequence, then ``wo``."""
        b, s, h, hd = q.shape
        out = layers.blockwise_attention(q, k, v, causal=True,
                                         block_kv=self.cfg.block_kv)
        return out.reshape(b, s, h * hd) @ self.wo

    def forward(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        return self.attend(*self.qkv(x, positions))


class Block(nn.Module):
    """Pre-norm residual block: attention, then the SwiGLU FFN (JAX
    ``_block`` with a dense FFN)."""

    def __init__(self, cfg: TransformerConfig, device):
        super().__init__()
        self.attn = Attention(cfg, device)
        self.ln1 = _weight((cfg.d_model,), cfg, device, fill=1.0)
        self.ln2 = _weight((cfg.d_model,), cfg, device, fill=1.0)
        self.ffn = layers.SwiGLU(cfg.d_model, cfg.d_ff, cfg.dtype, device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        return self.forward_kv(x, positions)[0]

    def forward_kv(self, x: torch.Tensor, positions: torch.Tensor):
        """(the block's output, this layer's k and v): ``prefill`` keeps
        the k and v that the attention used, as JAX re-derives them."""
        q, k, v = self.attn.qkv(layers.rms_norm(x, self.ln1), positions)
        x = x + self.attn.attend(q, k, v)
        return x + self.ffn(layers.rms_norm(x, self.ln2)), k, v


class ForwardOut(NamedTuple):
    hidden: torch.Tensor  # (B, S, d) final hidden (final norm applied)
    logits: torch.Tensor | None
    aux_loss: torch.Tensor
    z_loss: torch.Tensor


def lookup_ids(tokens: torch.Tensor, vocab: int) -> torch.Tensor:
    """The rows JAX's ``embed[tokens]`` reads: a negative id wraps once
    (``t + V``), then every id is clamped to [0, V-1]. Computed on the
    tokens' device with no host sync, so an out-of-range id neither
    asserts on the card nor differs from the CPU."""
    return torch.where(tokens < 0, tokens + vocab, tokens).clamp_(0, vocab - 1)


class Transformer(nn.Module):
    """A dense GQA transformer's weights and forward pass.

    Built uninitialised (norms are ones): :func:`init_params` draws the
    weights, ``convert.transformer_from_numpy`` copies JAX's.
    """

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        _check_supported(cfg)
        dev = resolve_device(device)
        self.cfg = cfg
        self.embed = _weight((cfg.vocab, cfg.d_model), cfg, dev)
        self.blocks = nn.ModuleList(Block(cfg, dev)
                                    for _ in range(cfg.n_layers))
        self.final_norm = _weight((cfg.d_model,), cfg, dev, fill=1.0)
        self.embed_head = (_weight((cfg.d_model, cfg.embed_dim), cfg, dev)
                           if cfg.embed_dim else None)

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, S) ids -> (B, S, d) rows of the token table, in cfg.dtype."""
        return self.embed[lookup_ids(tokens, self.cfg.vocab)].to(self.cfg.dtype)

    def forward(self, tokens: torch.Tensor, *,
                with_logits: bool = True) -> ForwardOut:
        """tokens: (B, S) integer ids on the model's device."""
        s = tokens.shape[1]
        x = self.embed_tokens(tokens)
        positions = torch.arange(s, device=x.device)
        remat = self.cfg.remat != "none" and torch.is_grad_enabled()
        for blk in self.blocks:
            x = (checkpoint(blk, x, positions, use_reentrant=False) if remat
                 else blk(x, positions))
        x = layers.rms_norm(x, self.final_norm)
        logits = x @ self.embed.T if with_logits else None  # tied head
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        return ForwardOut(hidden=x, logits=logits, aux_loss=zero, z_loss=zero)


# ==========================================================================
# entry points
# ==========================================================================
def init_params(seed: int, cfg: TransformerConfig, device=None) -> Transformer:
    """A :class:`Transformer` with random weights drawn on ``device`` (the
    card unless ``"cpu"``) from ``torch.Generator(device).manual_seed(seed)``:
    the token table normal·0.02, every matrix normal·1/sqrt(d_in), norms
    ones. JAX's distributions; not JAX's bits."""
    dev = resolve_device(device)
    model = Transformer(cfg, dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        model.embed.copy_(layers.embed_init(g, cfg.vocab, cfg.d_model,
                                            cfg.dtype))
        for blk in model.blocks:
            a, f = blk.attn, blk.ffn
            for w in (a.wq, a.wk, a.wv, a.wo, f.w_gate, f.w_up, f.w_down):
                w.copy_(layers.dense_init(g, *w.shape, cfg.dtype))
        if model.embed_head is not None:
            model.embed_head.copy_(layers.dense_init(
                g, cfg.d_model, cfg.embed_dim, cfg.dtype))
    return model


def forward(model: Transformer, tokens: torch.Tensor, *,
            with_logits: bool = True) -> ForwardOut:
    """JAX's ``forward(params, tokens, cfg)``; the config is the model's."""
    return model(tokens, with_logits=with_logits)


def embed_pool(model: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    """Retrieval-embedding tower: mean-pool final hidden -> proj -> f32 ->
    l2 norm, in JAX's order of casts. (B, S) ids -> (B, embed_dim) f32."""
    pooled = forward(model, tokens, with_logits=False).hidden.mean(dim=1)
    if model.embed_head is not None:
        pooled = pooled @ model.embed_head
    pooled = pooled.float()
    return pooled * torch.rsqrt((pooled * pooled).sum(-1, keepdim=True) + 1e-9)


# --------------------------------------------------------------------------
# the LM loss
# --------------------------------------------------------------------------
def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each position's logsumexp(logits) - logits[label], in f32."""
    lf = logits.float()
    gold = lf.gather(-1, labels.long()[..., None])[..., 0]
    return torch.logsumexp(lf, dim=-1) - gold


def _chunk_ce(hidden: torch.Tensor, embed: torch.Tensor,
              labels: torch.Tensor) -> torch.Tensor:
    """The summed cross entropy of one chunk's tied-head logits."""
    return _nll(hidden @ embed.T, labels).sum()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean over positions of logsumexp(logits) - logits[label], in f32."""
    return _nll(logits, labels).mean()


def chunked_cross_entropy(hidden: torch.Tensor, embed: torch.Tensor,
                          labels: torch.Tensor, chunk: int) -> torch.Tensor:
    """Cross entropy against the tied head without the (B, S, V) logits: the
    sequence in chunks of ``chunk`` positions (and the remainder), each
    chunk's logits recomputed in the backward pass (``torch.utils.
    checkpoint``, as JAX's ``jax.checkpoint``); the chunks' sums added in
    order, over B·S."""
    b, s, _ = hidden.shape
    chunk = min(chunk, s)
    remat = torch.is_grad_enabled()
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for lo in range(0, s, chunk):
        args = (hidden[:, lo:lo + chunk], embed, labels[:, lo:lo + chunk])
        total = total + (checkpoint(_chunk_ce, *args, use_reentrant=False)
                         if remat else _chunk_ce(*args))
    return total / (b * s)


def loss_fn(model: Transformer, batch: dict) -> tuple[torch.Tensor, dict]:
    """JAX's ``loss_fn(params, batch, cfg)``: next-token cross entropy
    (chunked when S > ``cfg.ce_chunk``) plus the aux and z losses at JAX's
    coefficients (both 0 for a dense model). ``batch``: ``tokens`` and
    ``labels``, (B, S) ids (numpy arrays or tensors; moved to the model's
    device). Returns (total, {"ce", "aux", "z", "loss"})."""
    cfg = model.cfg
    dev = model.embed.device
    tokens = as_tensor(batch["tokens"], dev)
    labels = as_tensor(batch["labels"], dev)
    use_chunked = bool(cfg.ce_chunk) and tokens.shape[1] > cfg.ce_chunk
    out = forward(model, tokens, with_logits=not use_chunked)
    if use_chunked:
        ce = chunked_cross_entropy(out.hidden, model.embed, labels,
                                   cfg.ce_chunk)
    else:
        ce = cross_entropy(out.logits, labels)
    total = ce + cfg.aux_loss_coef * out.aux_loss + cfg.z_loss_coef * out.z_loss
    return total, {"ce": ce, "aux": out.aux_loss, "z": out.z_loss,
                   "loss": total}


# --------------------------------------------------------------------------
# the decode path
# --------------------------------------------------------------------------
class KVCache(NamedTuple):
    """k, v: (L, B, S, Hkv, dh) in cfg.dtype; ``length``: a 0-d int32 tensor
    on the cache's device, the tokens already in the cache."""
    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor


def init_cache(cfg: TransformerConfig, batch: int, max_seq: int,
               length: int = 0, device=None) -> KVCache:
    """An empty cache of ``max_seq`` positions on ``device`` (the card
    unless ``"cpu"``)."""
    _check_supported(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=cfg.dtype, device=dev),
                   v=torch.zeros(shape, dtype=cfg.dtype, device=dev),
                   length=torch.tensor(length, dtype=torch.int32, device=dev))


@torch.no_grad()
def prefill(model: Transformer, tokens: torch.Tensor,
            max_seq: int | None = None) -> tuple[torch.Tensor, KVCache]:
    """Run the prompt (B, S) and return (the last position's logits (B, 1, V),
    a cache of ``max_seq`` (default S) positions holding the prompt's).

    The blocks' forward as in training (``blockwise_attention``); each
    layer's k (k-norm under qk-norm, then RoPE) and v are the ones its
    attention used, written into the cache's first S positions. The logits
    are ``hidden[:, -1:] @ embed.T``: the (B, S, V) logits are never made.
    """
    cfg = model.cfg
    b, s = tokens.shape
    cache = init_cache(cfg, b, max_seq or s, length=s, device=tokens.device)
    x = model.embed_tokens(tokens)
    positions = torch.arange(s, device=x.device)
    for i, blk in enumerate(model.blocks):
        x, k, v = blk.forward_kv(x, positions)
        cache.k[i, :, :s] = k
        cache.v[i, :, :s] = v
    x = layers.rms_norm(x, model.final_norm)
    return x[:, -1:] @ model.embed.T, cache


def _decode_attn_gqa(attn: Attention, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """JAX's ``_decode_attn_gqa`` with the cache written in place: x (B, 1, d)
    at position ``length``; its k and v go into slot ``length`` of the
    layer's (B, S, Hkv, dh) cache (the last slot when the cache is full, as
    JAX's ``dynamic_update_slice`` clamps), then attention over
    ``length + 1`` keys."""
    b = x.shape[0]
    q, k, v = attn.qkv(x, length.view(1, 1).expand(b, 1))
    slot = length.clamp(max=cache_k.shape[1] - 1).view(1).long()
    cache_k.index_copy_(1, slot, k)
    cache_v.index_copy_(1, slot, v)
    out = layers.decode_attention(q, cache_k, cache_v, length=length + 1)
    return out.reshape(b, 1, -1) @ attn.wo


@torch.no_grad()
def decode_step(model: Transformer, tokens: torch.Tensor,
                cache: KVCache) -> tuple[torch.Tensor, KVCache]:
    """One decode step. tokens: (B, 1). Returns (logits (B, 1, V), the cache
    with ``length + 1``).

    The cache's k and v are updated in place (the returned cache holds the
    same tensors); no step reads a value back to the host, so steps queue
    on the card back to back."""
    length = cache.length
    x = model.embed_tokens(tokens)
    for i, blk in enumerate(model.blocks):
        x = x + _decode_attn_gqa(blk.attn, layers.rms_norm(x, blk.ln1),
                                 cache.k[i], cache.v[i], length)
        x = x + blk.ffn(layers.rms_norm(x, blk.ln2))
    x = layers.rms_norm(x, model.final_norm)
    return x @ model.embed.T, KVCache(cache.k, cache.v, length + 1)
