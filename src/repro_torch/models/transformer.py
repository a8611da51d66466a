"""The LM-family transformer, the counterpart of ``repro.models.transformer``:
dense GQA/MQA with optional qk-norm, DeepSeek's MLA (multi-head latent
attention, with the absorbed decode), MoE FFNs with shared experts
(``models/moe.py``) and the MTP head; the embedding towers
(``embed_pool``), the LM loss with its aux, z and MTP terms (``loss_fn``)
and the decode path (``prefill``, ``decode_step``).

PyTorch idiom: a :class:`Transformer` ``nn.Module`` holds the weights, one
:class:`Block` per layer (not JAX's stacked scans over ``dense_blocks`` and
``moe_blocks``: the first ``first_dense`` blocks of an MoE model hold an
``ffn``, the rest a ``moe``), each weight an ``nn.Parameter`` in JAX's
(d_in, d_out) layout so that ``x @ w`` is the same product and a JAX pytree
converts by copying (``convert.transformer_from_numpy``). :func:`init_params`
draws them on the card from a seeded ``torch.Generator``; pass
``device="cpu"`` for the CPU.

Attention runs in ``layers.blockwise_attention`` (the hand-written
``flash_attention`` kernel on the card, and its backward kernel under
grad); MLA attends at qk 192 / v 128 with its shared RoPE key broadcast to
the H heads. The plain products (``x @ W``, the MoE's expert products) are
PyTorch's. ``remat="full"`` recomputes each block in the backward pass
(``torch.utils.checkpoint``), as JAX's ``jax.checkpoint`` per block. JAX's
``constrain_batch`` / ``constrain_seq`` are sharding hints that do nothing
without a mesh, and are left out.

The decode path keeps JAX's cache layouts: GQA (L, B, S, Hkv, dh) read
through the hand-written ``flash_decode`` without repeating it to H heads;
MLA (L, B, S, kv_lora_rank) latents and (L, B, S, qk_rope_dim) RoPE keys,
read by JAX's absorbed decode (plain products in f32, one layer's cache
upcast at a time). Two deliberate differences make a step the card can run
back to back: ``decode_step`` writes the new cache entries *in place* (JAX
returns a new cache; a functional copy of a 32k cache at every token is not
an option), and the cache's ``length`` stays on the cache's device, so a
step never waits for the host (the MoE dispatch keeps its shapes static for
the same reason).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.backend import as_tensor, resolve_device
from repro_torch.models import layers
from repro_torch.models.moe import MoE, MoEConfig, fill_moe, moe_ffn


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

    def moe_cfg(self) -> MoEConfig:
        return MoEConfig(
            n_experts=self.n_experts,
            top_k=self.top_k,
            d_model=self.d_model,
            d_ff=self.moe_d_ff,
            n_shared=self.n_shared,
            capacity_factor=self.capacity_factor,
            dtype=self.dtype,
        )

    @property
    def n_dense(self) -> int:
        """Leading blocks with a dense FFN (all of them without MoE)."""
        return self.first_dense if self.moe else self.n_layers


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

    def forward_kv(self, x: torch.Tensor, positions: torch.Tensor):
        """(the attention's output, this layer's cache pair: k and v (B, S,
        Hkv, dh) after qk-norm and RoPE, as the attention used them)."""
        q, k, v = self.qkv(x, positions)
        return self.attend(q, k, v), k, v

    def forward(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        return self.attend(*self.qkv(x, positions))


class MLAAttention(nn.Module):
    """DeepSeek's multi-head latent attention (JAX ``_attention``, MLA path):
    q through a rank-``q_lora_rank`` bottleneck, k and v from one
    rank-``kv_lora_rank`` latent ``c_kv`` per token, and one RoPE key of
    ``qk_rope_dim`` per token shared by the H heads."""

    def __init__(self, cfg: TransformerConfig, device):
        super().__init__()
        d, h = cfg.d_model, cfg.n_heads
        self.cfg = cfg
        self.q_a = _weight((d, cfg.q_lora_rank), cfg, device)
        self.q_a_norm = _weight((cfg.q_lora_rank,), cfg, device, fill=1.0)
        self.q_b = _weight((cfg.q_lora_rank, h * cfg.qk_dim), cfg, device)
        self.kv_a = _weight((d, cfg.kv_lora_rank + cfg.qk_rope_dim), cfg,
                            device)
        self.kv_a_norm = _weight((cfg.kv_lora_rank,), cfg, device, fill=1.0)
        self.k_b = _weight((cfg.kv_lora_rank, h * cfg.qk_nope_dim), cfg,
                           device)
        self.v_b = _weight((cfg.kv_lora_rank, h * cfg.v_head_dim), cfg,
                           device)
        self.wo = _weight((h * cfg.v_head_dim, d), cfg, device)

    def query(self, x: torch.Tensor, positions: torch.Tensor):
        """q_nope and q_rope (B, S, H, nope | rope) of x (B, S, d), RoPE at
        ``positions`` on q_rope."""
        cfg = self.cfg
        b, s, _ = x.shape
        qa = layers.rms_norm(x @ self.q_a, self.q_a_norm)
        q = (qa @ self.q_b).view(b, s, cfg.n_heads, cfg.qk_dim)
        q_nope, q_rope = q.split([cfg.qk_nope_dim, cfg.qk_rope_dim], dim=-1)
        return q_nope, layers.apply_rope(q_rope, positions, cfg.rope_theta)

    def latent(self, x: torch.Tensor, positions: torch.Tensor):
        """What the cache holds of x (B, S, d): c_kv (B, S, rank) after its
        norm, and k_rope (B, S, rope) after RoPE at ``positions``."""
        cfg = self.cfg
        c_kv, k_rope = (x @ self.kv_a).split(
            [cfg.kv_lora_rank, cfg.qk_rope_dim], dim=-1)
        c_kv = layers.rms_norm(c_kv, self.kv_a_norm)
        k_rope = layers.apply_rope(k_rope[:, :, None, :], positions,
                                   cfg.rope_theta)[:, :, 0]
        return c_kv, k_rope

    def forward_kv(self, x: torch.Tensor, positions: torch.Tensor):
        """(the attention's output, this layer's cache pair c_kv and
        k_rope): k = [c_kv @ k_b ; k_rope broadcast to the H heads], v =
        c_kv @ v_b, causal attention at scale 1/sqrt(qk_dim), then ``wo``."""
        cfg = self.cfg
        b, s, _ = x.shape
        h = cfg.n_heads
        q_nope, q_rope = self.query(x, positions)
        c_kv, k_rope = self.latent(x, positions)
        k_nope = (c_kv @ self.k_b).view(b, s, h, cfg.qk_nope_dim)
        v = (c_kv @ self.v_b).view(b, s, h, cfg.v_head_dim)
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
            b, s, h, cfg.qk_rope_dim)], dim=-1)
        out = layers.blockwise_attention(q, k, v, causal=True,
                                         block_kv=cfg.block_kv,
                                         scale=1.0 / math.sqrt(cfg.qk_dim))
        return out.reshape(b, s, h * cfg.v_head_dim) @ self.wo, c_kv, k_rope


class Block(nn.Module):
    """Pre-norm residual block: attention (GQA or MLA), then a SwiGLU FFN or,
    with ``use_moe``, an MoE FFN (JAX ``_block``)."""

    def __init__(self, cfg: TransformerConfig, device, use_moe: bool = False):
        super().__init__()
        self.attn = (MLAAttention if cfg.mla else Attention)(cfg, device)
        self.ln1 = _weight((cfg.d_model,), cfg, device, fill=1.0)
        self.ln2 = _weight((cfg.d_model,), cfg, device, fill=1.0)
        self.use_moe = use_moe
        if use_moe:
            self.moe = MoE(cfg.moe_cfg(), device)
        else:
            self.ffn = layers.SwiGLU(cfg.d_model, cfg.d_ff, cfg.dtype, device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor):
        """(the block's output, its MoE's f32 aux and z losses; both None in
        a dense block)."""
        x, _, _, aux, z = self.forward_kv(x, positions)
        return x, aux, z

    def forward_kv(self, x: torch.Tensor, positions: torch.Tensor):
        """(output, this layer's cache pair, aux, z): ``prefill`` keeps the
        cache entries that the attention used, as JAX re-derives them."""
        a, ck, cv = self.attn.forward_kv(layers.rms_norm(x, self.ln1),
                                         positions)
        x, aux, z = self.ffn_residual(x + a)
        return x, ck, cv, aux, z

    def ffn_residual(self, x: torch.Tensor):
        """(x + FFN(rms_norm(x)), aux, z): the block's second half."""
        hn = layers.rms_norm(x, self.ln2)
        if not self.use_moe:
            return x + self.ffn(hn), None, None
        out = moe_ffn(self.moe, hn, self.moe.cfg)
        return x + out.y, out.aux_loss, out.z_loss


class MTP(nn.Module):
    """The multi-token-prediction head (DeepSeek-V3): ``proj`` (2d, d) of
    [h_t ; emb(token_{t+1})], one dense ``block``, then ``norm``."""

    def __init__(self, cfg: TransformerConfig, device):
        super().__init__()
        self.proj = _weight((2 * cfg.d_model, cfg.d_model), cfg, device)
        self.block = Block(cfg, device)
        self.norm = _weight((cfg.d_model,), cfg, device, fill=1.0)


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
    """A transformer's weights and forward pass: ``blocks`` (the first
    ``cfg.n_dense`` with a dense FFN, the rest with an MoE), ``mtp`` when
    ``cfg.mtp``, ``embed_head`` when ``cfg.embed_dim``.

    Built uninitialised (norms are ones): :func:`init_params` draws the
    weights, ``convert.transformer_from_numpy`` copies JAX's.
    """

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.embed = _weight((cfg.vocab, cfg.d_model), cfg, dev)
        self.blocks = nn.ModuleList(Block(cfg, dev, use_moe=i >= cfg.n_dense)
                                    for i in range(cfg.n_layers))
        self.final_norm = _weight((cfg.d_model,), cfg, dev, fill=1.0)
        self.embed_head = (_weight((cfg.d_model, cfg.embed_dim), cfg, dev)
                           if cfg.embed_dim else None)
        self.mtp = MTP(cfg, dev) if cfg.mtp else None

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, S) ids -> (B, S, d) rows of the token table, in cfg.dtype."""
        return self.embed[lookup_ids(tokens, self.cfg.vocab)].to(self.cfg.dtype)

    def forward(self, tokens: torch.Tensor, *,
                with_logits: bool = True) -> ForwardOut:
        """tokens: (B, S) integer ids on the model's device. ``aux_loss`` and
        ``z_loss`` are the MoE blocks' sums, in layer order (0 without)."""
        s = tokens.shape[1]
        x = self.embed_tokens(tokens)
        positions = torch.arange(s, device=x.device)
        remat = self.cfg.remat != "none" and torch.is_grad_enabled()
        aux = z = torch.zeros((), dtype=torch.float32, device=x.device)
        for blk in self.blocks:
            x, a, zz = (checkpoint(blk, x, positions, use_reentrant=False)
                        if remat else blk(x, positions))
            if a is not None:
                aux, z = aux + a, z + zz
        x = layers.rms_norm(x, self.final_norm)
        logits = x @ self.embed.T if with_logits else None  # tied head
        return ForwardOut(hidden=x, logits=logits, aux_loss=aux, z_loss=z)


# ==========================================================================
# entry points
# ==========================================================================
def _fill_block(g: torch.Generator, blk: Block, cfg: TransformerConfig) -> None:
    a = blk.attn
    names = (("q_a", "q_b", "kv_a", "k_b", "v_b", "wo") if cfg.mla
             else ("wq", "wk", "wv", "wo"))
    ws = [getattr(a, n) for n in names]
    if not blk.use_moe:
        ws += [blk.ffn.w_gate, blk.ffn.w_up, blk.ffn.w_down]
    for w in ws:
        w.copy_(layers.dense_init(g, *w.shape, cfg.dtype))
    if blk.use_moe:
        fill_moe(g, blk.moe)


def init_params(seed: int, cfg: TransformerConfig, device=None) -> Transformer:
    """A :class:`Transformer` with random weights drawn on ``device`` (the
    card unless ``"cpu"``) from ``torch.Generator(device).manual_seed(seed)``:
    the token table normal·0.02, every matrix normal·1/sqrt(d_in) (the MoE's
    as ``moe.fill_moe``: its router in f32, its experts one at a time),
    norms ones; in order the table, each block, the embedding head, the MTP
    head. JAX's distributions; not JAX's bits."""
    dev = resolve_device(device)
    model = Transformer(cfg, dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        model.embed.copy_(layers.embed_init(g, cfg.vocab, cfg.d_model,
                                            cfg.dtype))
        for blk in model.blocks:
            _fill_block(g, blk, cfg)
        if model.embed_head is not None:
            model.embed_head.copy_(layers.dense_init(
                g, cfg.d_model, cfg.embed_dim, cfg.dtype))
        if model.mtp is not None:
            model.mtp.proj.copy_(layers.dense_init(
                g, 2 * cfg.d_model, cfg.d_model, cfg.dtype))
            _fill_block(g, model.mtp.block, cfg)
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
    coefficients (both 0 for a dense model) and, under ``cfg.mtp``, the MTP
    head's cross entropy at ``mtp_coef``. ``batch``: ``tokens`` and
    ``labels``, (B, S) ids (numpy arrays or tensors; moved to the model's
    device). Returns (total, {"ce", "aux", "z", ["mtp_ce",] "loss"})."""
    cfg = model.cfg
    dev = model.embed.device
    tokens = as_tensor(batch["tokens"], dev)
    labels = as_tensor(batch["labels"], dev)
    use_chunked = bool(cfg.ce_chunk) and tokens.shape[1] > cfg.ce_chunk

    def ce_of(hidden, lab):
        if use_chunked:
            return chunked_cross_entropy(hidden, model.embed, lab,
                                         cfg.ce_chunk)
        return cross_entropy(hidden @ model.embed.T, lab)

    out = forward(model, tokens, with_logits=False)
    ce = ce_of(out.hidden, labels)
    total = ce + cfg.aux_loss_coef * out.aux_loss + cfg.z_loss_coef * out.z_loss
    metrics = {"ce": ce, "aux": out.aux_loss, "z": out.z_loss}
    if cfg.mtp:
        # one extra block predicts token t+2 from [h_t ; emb(token_{t+1})];
        # position t's target is labels[t+1]
        m = model.mtp
        nxt = model.embed_tokens(tokens[:, 1:])
        hm = torch.cat([out.hidden[:, :-1], nxt], dim=-1) @ m.proj
        hm = m.block(hm, torch.arange(hm.shape[1], device=dev))[0]
        mtp_ce = ce_of(layers.rms_norm(hm, m.norm), labels[:, 1:])
        total = total + cfg.mtp_coef * mtp_ce
        metrics["mtp_ce"] = mtp_ce
    metrics["loss"] = total
    return total, metrics


# --------------------------------------------------------------------------
# the decode path
# --------------------------------------------------------------------------
class KVCache(NamedTuple):
    """GQA: k, v (L, B, S, Hkv, dh). MLA: k the latents c_kv (L, B, S,
    kv_lora_rank), v the RoPE keys k_rope (L, B, S, qk_rope_dim). In
    cfg.dtype; ``length``: a 0-d int32 tensor on the cache's device, the
    tokens already in the cache."""
    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor


def init_cache(cfg: TransformerConfig, batch: int, max_seq: int,
               length: int = 0, device=None) -> KVCache:
    """An empty cache of ``max_seq`` positions on ``device`` (the card
    unless ``"cpu"``), in JAX's layout for ``cfg``."""
    dev = resolve_device(device)
    lead = (cfg.n_layers, batch, max_seq)
    if cfg.mla:
        k_shape, v_shape = (*lead, cfg.kv_lora_rank), (*lead, cfg.qk_rope_dim)
    else:
        k_shape = v_shape = (*lead, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(k=torch.zeros(k_shape, dtype=cfg.dtype, device=dev),
                   v=torch.zeros(v_shape, dtype=cfg.dtype, device=dev),
                   length=torch.tensor(length, dtype=torch.int32, device=dev))


@torch.no_grad()
def prefill(model: Transformer, tokens: torch.Tensor,
            max_seq: int | None = None) -> tuple[torch.Tensor, KVCache]:
    """Run the prompt (B, S) and return (the last position's logits (B, 1, V),
    a cache of ``max_seq`` (default S) positions holding the prompt's).

    The blocks' forward as in training (``blockwise_attention``); each
    layer's cache entries are the ones its attention used (GQA: k after
    k-norm under qk-norm and RoPE, and v; MLA: c_kv after its norm, and
    k_rope after RoPE), written into the cache's first S positions. The
    logits are ``hidden[:, -1:] @ embed.T``: the (B, S, V) logits are never
    made.
    """
    cfg = model.cfg
    b, s = tokens.shape
    cache = init_cache(cfg, b, max_seq or s, length=s, device=tokens.device)
    x = model.embed_tokens(tokens)
    positions = torch.arange(s, device=x.device)
    for i, blk in enumerate(model.blocks):
        x, k, v, _, _ = blk.forward_kv(x, positions)
        cache.k[i, :, :s] = k
        cache.v[i, :, :s] = v
    x = layers.rms_norm(x, model.final_norm)
    return x[:, -1:] @ model.embed.T, cache


def _write_slot(cache: torch.Tensor, new: torch.Tensor,
                length: torch.Tensor) -> None:
    """Write ``new`` (B, 1, ...) into slot ``length`` of one layer's cache
    (B, S, ...) in place: the last slot when the cache is full, as JAX's
    ``dynamic_update_slice`` clamps."""
    slot = length.clamp(max=cache.shape[1] - 1).view(1).long()
    cache.index_copy_(1, slot, new)


def _decode_attn_gqa(attn: Attention, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """JAX's ``_decode_attn_gqa`` with the cache written in place: x (B, 1, d)
    at position ``length``; its k and v go into slot ``length`` of the
    layer's (B, S, Hkv, dh) cache, then attention over ``length + 1``
    keys."""
    b = x.shape[0]
    q, k, v = attn.qkv(x, length.view(1, 1).expand(b, 1))
    _write_slot(cache_k, k, length)
    _write_slot(cache_v, v, length)
    out = layers.decode_attention(q, cache_k, cache_v, length=length + 1)
    return out.reshape(b, 1, -1) @ attn.wo


def _decode_attn_mla(attn: MLAAttention, x: torch.Tensor,
                     cache_c: torch.Tensor, cache_r: torch.Tensor,
                     length: torch.Tensor) -> torch.Tensor:
    """JAX's absorbed MLA decode with the cache written in place: x (B, 1, d)
    at position ``length``; its c_kv and k_rope go into slot ``length`` of
    the layer's (B, S, rank) and (B, S, rope) caches. ``k_b`` is folded into
    the query (q_abs = q_nope · W_UK) and ``v_b`` applied to the context, so
    the cache is never expanded to H heads. Scores, softmax and context in
    f32, as JAX: this layer's cache is upcast to f32 here, one layer at a
    time."""
    cfg = attn.cfg
    b = x.shape[0]
    h, rank = cfg.n_heads, cfg.kv_lora_rank
    pos = length.view(1, 1).expand(b, 1)
    q_nope, q_rope = attn.query(x, pos)
    c_new, r_new = attn.latent(x, pos)
    _write_slot(cache_c, c_new, length)
    _write_slot(cache_r, r_new, length)
    w_uk = attn.k_b.view(rank, h, cfg.qk_nope_dim)
    q_abs = torch.einsum("bhn,rhn->bhr", q_nope[:, 0], w_uk)
    c32 = cache_c.float()
    s_c = torch.einsum("bhr,bsr->bhs", q_abs.float(), c32)
    s_r = torch.einsum("bhd,bsd->bhs", q_rope[:, 0].float(), cache_r.float())
    logits = (s_c + s_r) / math.sqrt(cfg.qk_dim)
    valid = torch.arange(cache_c.shape[1], device=x.device) < length + 1
    logits = logits.masked_fill(~valid, -torch.inf)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True).clamp(min=1e-30)
    ctx = torch.einsum("bhs,bsr->bhr", p, c32)
    w_uv = attn.v_b.view(rank, h, cfg.v_head_dim)
    out = torch.einsum("bhr,rhv->bhv", ctx, w_uv.float()).to(cfg.dtype)
    return out.reshape(b, 1, h * cfg.v_head_dim) @ attn.wo


@torch.no_grad()
def decode_step(model: Transformer, tokens: torch.Tensor,
                cache: KVCache) -> tuple[torch.Tensor, KVCache]:
    """One decode step. tokens: (B, 1). Returns (logits (B, 1, V), the cache
    with ``length + 1``).

    The cache's k and v are updated in place (the returned cache holds the
    same tensors); no step reads a value back to the host, so steps queue
    on the card back to back. An MoE block dispatches the batch's B tokens
    as one group, as JAX's."""
    length = cache.length
    attend = _decode_attn_mla if model.cfg.mla else _decode_attn_gqa
    x = model.embed_tokens(tokens)
    for i, blk in enumerate(model.blocks):
        x = x + attend(blk.attn, layers.rms_norm(x, blk.ln1), cache.k[i],
                       cache.v[i], length)
        x = blk.ffn_residual(x)[0]
    x = layers.rms_norm(x, model.final_norm)
    return x @ model.embed.T, KVCache(cache.k, cache.v, length + 1)
