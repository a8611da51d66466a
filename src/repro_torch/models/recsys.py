"""The recommender models, the counterparts of ``repro.models.recsys``: BST,
DIN, BERT4Rec and xDeepFM.

In the bi-metric system these are the *expensive metric D*: scoring a
(user, candidate) pair takes a forward pass (target attention, or a CIN over
the joint features) and cannot be precomputed. ``*_score_candidates`` is the
budgeted D-call entry; cheap retrieval embeddings provide d.

PyTorch idiom: one ``nn.Module`` per model holds its weights, each an
``nn.Parameter`` whose dotted path is JAX's pytree path (``blocks.0.wq``,
``head.ws.2``, ``cin.1``, ``bias``), in JAX's (d_in, d_out) layout, so that
``convert.recsys_from_numpy`` copies a JAX pytree as it is and the
``Trainer`` and ``CheckpointManager`` take the module unchanged. The
functions keep JAX's names and take the module (its ``cfg`` is the
config), as ``transformer.forward`` does. ``*_init(key, cfg, device=None)``
draws the weights from a seeded ``torch.Generator`` (``key`` a seed, on the
card unless ``device="cpu"``, or a generator, on its device): JAX's
distributions, not JAX's bits.

BST and BERT4Rec attend through ``layers.blockwise_attention(causal=False)``:
on the card the hand-written ``flash_attention`` kernel (f32: the SIMT
forward; under grad its backward kernel, the ``simt`` route for BST's heads
of 4 and ``tf32`` for BERT4Rec's of 32), on the CPU its plain version. The
bags and lookups are plain row gathers (``F.embedding``), as JAX's are plain
``jnp.take``; the products are PyTorch's. JAX's ``constrain_batch`` /
``constrain_axis`` are sharding hints that do nothing on one card and are
left out.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.backend import as_tensor, resolve_device
from repro_torch.models import layers


# --------------------------------------------------------------------------
# EmbeddingBag
# --------------------------------------------------------------------------
def embedding_bag(table: torch.Tensor, idx: torch.Tensor,
                  mask: torch.Tensor | None = None,
                  mode: str = "sum") -> torch.Tensor:
    """Fixed-shape bag: table (V, D), idx (..., L) -> (..., D).

    ``mask`` (..., L) marks valid entries (padding rows excluded from the
    reduce); without one, an id of -1 is padding: it takes row 0 and is
    masked to zero. mode: sum | mean."""
    rows = F.embedding(idx.clamp(min=0), table)
    if mask is None:
        mask = idx >= 0
    mask = mask.to(rows.dtype)
    s = (rows * mask[..., None]).sum(-2)
    if mode == "mean":
        s = s / mask.sum(-1, keepdim=True).clamp(min=1.0)
    return s


def _segment_sum(x: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """JAX's ``segment_sum(x, seg, num_segments=n)`` for seg >= 0: rows of an
    id past n are dropped (they land in a spare row that is cut off)."""
    seg = torch.where(seg < n, seg, n).long()
    out = torch.zeros((n + 1, *x.shape[1:]), dtype=x.dtype, device=x.device)
    return out.index_add(0, seg, x)[:n]


def embedding_bag_ragged(table: torch.Tensor, indices: torch.Tensor,
                         segment_ids: torch.Tensor, n_bags: int,
                         mode: str = "sum") -> torch.Tensor:
    """Ragged multi-hot bag: gather rows, then a segment sum per bag
    (``index_add`` for JAX's ``segment_sum``); pad ids (-1) add nothing."""
    valid = indices >= 0
    rows = F.embedding(indices.clamp(min=0), table)
    rows = rows * valid[:, None].to(rows.dtype)
    seg = segment_ids.clamp(min=0)
    out = _segment_sum(rows, seg, n_bags)
    if mode == "mean":
        cnt = _segment_sum(valid.to(rows.dtype), seg, n_bags)
        out = out / cnt.clamp(min=1.0)[:, None]
    return out


def _bce(logit: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Mean binary cross entropy of logits, in f32 (JAX's stable form)."""
    lf = logit.float()
    return (lf.clamp(min=0) - lf * label.float()
            + torch.log1p(torch.exp(-lf.abs()))).mean()


# --------------------------------------------------------------------------
# modules and initialisers
# --------------------------------------------------------------------------
def _param(shape, dtype, device, fill=None) -> nn.Parameter:
    w = torch.empty(shape, dtype=dtype, device=device)
    return nn.Parameter(w if fill is None else w.fill_(fill))


def _generator(key, device) -> torch.Generator:
    """``key`` as a generator: a seed on ``device`` (the card unless
    ``"cpu"``), or a ``torch.Generator`` as it is."""
    if isinstance(key, torch.Generator):
        return key
    return torch.Generator(device=resolve_device(device)).manual_seed(key)


def _draw(w: nn.Parameter, values: torch.Tensor) -> None:
    with torch.no_grad():
        w.copy_(values)


class MLP(nn.Module):
    """JAX's ``{"ws": [...], "bs": [...]}``: dims[i] -> dims[i+1] layers."""

    def __init__(self, dims, dtype, device):
        super().__init__()
        pairs = list(zip(dims[:-1], dims[1:]))
        self.ws = nn.ParameterList(_param((a, b), dtype, device)
                                   for a, b in pairs)
        self.bs = nn.ParameterList(_param((b,), dtype, device, 0.0)
                                   for _, b in pairs)

    def forward(self, x: torch.Tensor, act) -> torch.Tensor:
        return layers.mlp(x, self.ws, self.bs, act=act)


def _init_mlp(g: torch.Generator, m: MLP, dtype) -> None:
    """JAX's ``_init_mlp``: each ``ws`` normal/sqrt(d_in) (the ``bs`` are
    zeros from the constructor)."""
    for w in m.ws:
        _draw(w, layers.dense_init(g, *w.shape, dtype))


class EncoderBlock(nn.Module):
    """One post-attention encoder block of BST and BERT4Rec (JAX's dict of
    ``wq wk wv wo ln1 ln1b ffn ln2 ln2b``)."""

    def __init__(self, d: int, dtype, device):
        super().__init__()
        for name in ("wq", "wk", "wv", "wo"):
            setattr(self, name, _param((d, d), dtype, device))
        self.ln1 = _param((d,), dtype, device, 1.0)
        self.ln1b = _param((d,), dtype, device, 0.0)
        self.ffn = MLP([d, 4 * d, d], dtype, device)
        self.ln2 = _param((d,), dtype, device, 1.0)
        self.ln2b = _param((d,), dtype, device, 0.0)


def _init_block(g: torch.Generator, blk: EncoderBlock, dtype) -> None:
    for w in (blk.wq, blk.wk, blk.wv, blk.wo):
        _draw(w, layers.dense_init(g, *w.shape, dtype))
    _init_mlp(g, blk.ffn, dtype)


def _mha(blk: EncoderBlock, x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Non-causal multi-head self-attention through ``blockwise_attention``
    (``block_kv`` is JAX's memory knob, accepted and ignored there)."""
    b, s, d = x.shape
    hd = d // n_heads
    q = (x @ blk.wq).view(b, s, n_heads, hd)
    k = (x @ blk.wk).view(b, s, n_heads, hd)
    v = (x @ blk.wv).view(b, s, n_heads, hd)
    out = layers.blockwise_attention(q, k, v, causal=False,
                                     block_kv=max(s, 16))
    return out.reshape(b, s, d) @ blk.wo


def _encoder_block(blk: EncoderBlock, x: torch.Tensor, n_heads: int,
                   act) -> torch.Tensor:
    h = layers.layer_norm(x, blk.ln1, blk.ln1b)
    x = x + _mha(blk, h, n_heads)
    h = layers.layer_norm(x, blk.ln2, blk.ln2b)
    return x + blk.ffn(h, act)


def _remat(fn, *args):
    """``fn(*args)``, recomputed in the backward pass under grad
    (``torch.utils.checkpoint``, as JAX's ``jax.checkpoint``)."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# ==========================================================================
# BST — Behavior Sequence Transformer (arXiv:1905.06874)
# ==========================================================================
@dataclasses.dataclass(frozen=True)
class BSTConfig:
    name: str = "bst"
    vocab: int = 1_048_576
    embed_dim: int = 32
    seq_len: int = 20
    n_blocks: int = 1
    n_heads: int = 8
    mlp_dims: tuple = (1024, 512, 256)
    dtype: Any = torch.float32


class BST(nn.Module):
    def __init__(self, cfg: BSTConfig, device):
        super().__init__()
        self.cfg = cfg
        d, s1, dt = cfg.embed_dim, cfg.seq_len + 1, cfg.dtype
        self.item_emb = _param((cfg.vocab, d), dt, device)
        self.pos_emb = _param((s1, d), dt, device)
        self.blocks = nn.ModuleList(EncoderBlock(d, dt, device)
                                    for _ in range(cfg.n_blocks))
        self.head = MLP([s1 * d, *cfg.mlp_dims, 1], dt, device)


def bst_init(key, cfg: BSTConfig, device=None) -> BST:
    g = _generator(key, device)
    model = BST(cfg, g.device)
    d, dt = cfg.embed_dim, cfg.dtype
    _draw(model.item_emb, layers.embed_init(g, cfg.vocab, d, dt))
    _draw(model.pos_emb, layers.embed_init(g, cfg.seq_len + 1, d, dt))
    _init_mlp(g, model.head, dt)
    for blk in model.blocks:
        _init_block(g, blk, dt)
    return model


def bst_forward(model: BST, hist: torch.Tensor,
                target: torch.Tensor) -> torch.Tensor:
    """hist (B, L) item ids (-1 pad), target (B,) -> logits (B,). Each
    position is a bag of one id (``embedding_bag``): a padded item is a
    zero row plus its position embedding."""
    cfg = model.cfg
    b = hist.shape[0]
    seq = torch.cat([hist, target[:, None].to(hist.dtype)], dim=1)
    x = embedding_bag(model.item_emb, seq[..., None])  # (B, L+1, D)
    x = x + model.pos_emb[None]
    for blk in model.blocks:
        x = _encoder_block(blk, x, cfg.n_heads, F.leaky_relu)
    return model.head(x.reshape(b, -1), F.leaky_relu)[:, 0]


def bst_loss(model: BST, batch: dict):
    dev = model.item_emb.device
    logit = bst_forward(model, as_tensor(batch["hist"], dev),
                        as_tensor(batch["target"], dev))
    loss = _bce(logit, as_tensor(batch["label"], dev))
    return loss, {"loss": loss}


def bst_score_candidates(model: BST, hist: torch.Tensor,
                         cand: torch.Tensor) -> torch.Tensor:
    """hist (1, L) one user; cand (N,) -> (N,) scores: the history
    broadcast to every candidate."""
    n = cand.shape[0]
    return bst_forward(model, hist.expand(n, hist.shape[1]), cand)


# ==========================================================================
# DIN — Deep Interest Network (arXiv:1706.06978)
# ==========================================================================
@dataclasses.dataclass(frozen=True)
class DINConfig:
    name: str = "din"
    vocab: int = 1_048_576
    embed_dim: int = 18
    seq_len: int = 100
    attn_mlp: tuple = (80, 40)
    mlp_dims: tuple = (200, 80)
    dtype: Any = torch.float32


class DIN(nn.Module):
    def __init__(self, cfg: DINConfig, device):
        super().__init__()
        self.cfg = cfg
        d, dt = cfg.embed_dim, cfg.dtype
        self.item_emb = _param((cfg.vocab, d), dt, device)
        self.attn = MLP([4 * d, *cfg.attn_mlp, 1], dt, device)
        self.head = MLP([2 * d, *cfg.mlp_dims, 1], dt, device)


def din_init(key, cfg: DINConfig, device=None) -> DIN:
    g = _generator(key, device)
    model = DIN(cfg, g.device)
    _draw(model.item_emb, layers.embed_init(g, cfg.vocab, cfg.embed_dim,
                                            cfg.dtype))
    _init_mlp(g, model.attn, cfg.dtype)
    _init_mlp(g, model.head, cfg.dtype)
    return model


def din_forward(model: DIN, hist: torch.Tensor,
                target: torch.Tensor) -> torch.Tensor:
    """Target attention over the history: weights from the attention MLP,
    a softmax over the valid positions (masked with -inf, then the masked
    weights set to 0, as JAX does: a history that is all padding has NaN
    weights after the softmax and 0 after the ``where``, so it pools to
    zero with finite gradients)."""
    h = F.embedding(hist.clamp(min=0), model.item_emb)  # (B, L, D)
    mask = hist >= 0
    t = F.embedding(target, model.item_emb)  # (B, D)
    tb = t[:, None].expand_as(h)
    att_in = torch.cat([h, tb, h - tb, h * tb], dim=-1)  # (B, L, 4D)
    w = model.attn(att_in, torch.sigmoid)[..., 0]  # (B, L)
    w = torch.where(mask, w.float(), float("-inf"))
    w = torch.softmax(w, dim=-1)
    w = torch.where(mask, w, 0.0).to(h.dtype)
    pooled = (h * w[..., None]).sum(dim=1)  # (B, D)
    feat = torch.cat([pooled, t], dim=-1)
    return model.head(feat, torch.sigmoid)[:, 0]


def din_loss(model: DIN, batch: dict):
    dev = model.item_emb.device
    logit = din_forward(model, as_tensor(batch["hist"], dev),
                        as_tensor(batch["target"], dev))
    loss = _bce(logit, as_tensor(batch["label"], dev))
    return loss, {"loss": loss}


def din_score_candidates(model: DIN, hist: torch.Tensor,
                         cand: torch.Tensor) -> torch.Tensor:
    """hist (1, L) one user; cand (N,) -> (N,) scores. Rows are independent,
    so a caller may split ``cand`` into chunks and concatenate."""
    n = cand.shape[0]
    return din_forward(model, hist.expand(n, hist.shape[1]), cand)


# ==========================================================================
# BERT4Rec (arXiv:1904.06690)
# ==========================================================================
@dataclasses.dataclass(frozen=True)
class Bert4RecConfig:
    name: str = "bert4rec"
    vocab: int = 65_536
    embed_dim: int = 64
    seq_len: int = 200
    n_blocks: int = 2
    n_heads: int = 2
    n_masked: int = 40  # masked positions per sequence (20%)
    dtype: Any = torch.float32


class Bert4Rec(nn.Module):
    def __init__(self, cfg: Bert4RecConfig, device):
        super().__init__()
        self.cfg = cfg
        d, dt = cfg.embed_dim, cfg.dtype
        self.item_emb = _param((cfg.vocab, d), dt, device)
        self.pos_emb = _param((cfg.seq_len, d), dt, device)
        self.blocks = nn.ModuleList(EncoderBlock(d, dt, device)
                                    for _ in range(cfg.n_blocks))
        self.final_ln = _param((d,), dt, device, 1.0)
        self.final_lnb = _param((d,), dt, device, 0.0)


def bert4rec_init(key, cfg: Bert4RecConfig, device=None) -> Bert4Rec:
    g = _generator(key, device)
    model = Bert4Rec(cfg, g.device)
    d, dt = cfg.embed_dim, cfg.dtype
    _draw(model.item_emb, layers.embed_init(g, cfg.vocab, d, dt))
    _draw(model.pos_emb, layers.embed_init(g, cfg.seq_len, d, dt))
    for blk in model.blocks:
        _init_block(g, blk, dt)
    return model


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def bert4rec_encode(model: Bert4Rec, items: torch.Tensor) -> torch.Tensor:
    """items (B, S) ids -> (B, S, D) final hidden. A pad id (-1) takes row 0
    with no mask, as JAX's ``jnp.maximum(items, 0)``; each block is
    recomputed in the backward pass (JAX's ``@jax.checkpoint``)."""
    cfg = model.cfg
    x = F.embedding(items.clamp(min=0), model.item_emb)
    x = x + model.pos_emb[None, : items.shape[1]]
    for blk in model.blocks:
        x = _remat(_encoder_block, blk, x, cfg.n_heads, _gelu)
    return layers.layer_norm(x, model.final_ln, model.final_lnb)


def _bert4rec_chunk_loss(model: Bert4Rec, items: torch.Tensor,
                         mask_pos: torch.Tensor,
                         mask_labels: torch.Tensor) -> torch.Tensor:
    """The summed masked-item cross entropy of one chunk of rows: the gold
    logit by a row-dot (no (b, M, V) gather), the logsumexp split over 16
    catalogue shards (one when V is no multiple of 16), in f32."""
    h = bert4rec_encode(model, items)  # (b, S, D)
    b, m = mask_pos.shape
    d = h.shape[-1]
    hm = torch.gather(h, 1, mask_pos.long()[..., None].expand(b, m, d))
    table = model.item_emb
    v = table.shape[0]
    gold_rows = F.embedding(mask_labels, table)
    gold = (hm.float() * gold_rows.float()).sum(-1)  # (b, M)
    n_shard = 16 if v % 16 == 0 else 1
    l4 = (hm @ table.T).view(b, m, n_shard, v // n_shard)
    lse = torch.logsumexp(torch.logsumexp(l4.float(), dim=-1), dim=-1)
    return (lse - gold).sum()


def bert4rec_loss(model: Bert4Rec, batch: dict, chunk: int = 8192):
    """Masked-item prediction: items (B, S), mask_pos (B, M), mask_labels
    (B, M). When B > ``chunk`` and B % chunk == 0 the rows go in chunks of
    ``chunk`` (JAX's scan), each recomputed in the backward pass, so the
    live logits block is one chunk deep; the chunks' sums are added in
    order. Otherwise one pass (recomputed too, as JAX's)."""
    dev = model.item_emb.device
    items, mask_pos, mask_labels = (
        as_tensor(batch[k], dev) for k in ("items", "mask_pos", "mask_labels"))
    n = items.shape[0]
    denom = n * model.cfg.n_masked
    if n <= chunk or n % chunk:
        loss = _remat(_bert4rec_chunk_loss, model, items, mask_pos,
                      mask_labels) / denom
        return loss, {"loss": loss}
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for lo in range(0, n, chunk):
        total = total + _remat(_bert4rec_chunk_loss, model,
                               items[lo:lo + chunk], mask_pos[lo:lo + chunk],
                               mask_labels[lo:lo + chunk])
    loss = total / denom
    return loss, {"loss": loss}


def bert4rec_score_candidates(model: Bert4Rec, items: torch.Tensor,
                              cand: torch.Tensor) -> torch.Tensor:
    """Next-item scores of the first user: last-position hidden · candidate
    item embeddings -> (N,) (JAX's ``[0]``)."""
    h = bert4rec_encode(model, items)[:, -1]  # (B, D)
    ce = F.embedding(cand, model.item_emb)  # (N, D)
    return (h @ ce.T)[0]


# ==========================================================================
# xDeepFM (arXiv:1803.05170)
# ==========================================================================
@dataclasses.dataclass(frozen=True)
class XDeepFMConfig:
    name: str = "xdeepfm"
    n_fields: int = 39
    field_vocab: int = 1_048_576  # rows per field (one stacked table)
    embed_dim: int = 10
    cin_layers: tuple = (200, 200, 200)
    mlp_dims: tuple = (400, 400)
    n_item_fields: int = 13  # trailing fields supplied by the candidate
    dtype: Any = torch.float32


class XDeepFM(nn.Module):
    def __init__(self, cfg: XDeepFMConfig, device):
        super().__init__()
        self.cfg = cfg
        m, d, dt = cfg.n_fields, cfg.embed_dim, cfg.dtype
        rows = m * cfg.field_vocab
        self.table = _param((rows, d), dt, device)
        self.linear = _param((rows, 1), dt, device)
        prev = [m, *cfg.cin_layers[:-1]]
        self.cin = nn.ParameterList(_param((h, hp * m), dt, device)
                                    for h, hp in zip(cfg.cin_layers, prev))
        self.dnn = MLP([m * d, *cfg.mlp_dims, 1], dt, device)
        self.cin_out = _param((sum(cfg.cin_layers), 1), dt, device)
        self.bias = _param((), dt, device, 0.0)


def xdeepfm_init(key, cfg: XDeepFMConfig, device=None) -> XDeepFM:
    g = _generator(key, device)
    model = XDeepFM(cfg, g.device)
    m, dt = cfg.n_fields, cfg.dtype
    rows = m * cfg.field_vocab
    _draw(model.table, layers.embed_init(g, rows, cfg.embed_dim, dt))
    _draw(model.linear, torch.randn((rows, 1), generator=g,
                                    device=g.device).mul_(0.01).to(dt))
    _init_mlp(g, model.dnn, dt)
    _draw(model.cin_out, layers.dense_init(g, sum(cfg.cin_layers), 1, dt))
    for w in model.cin:
        _draw(w, torch.randn(w.shape, generator=g, device=g.device).div_(
            w.shape[1] ** 0.5).to(dt))
    return model


def xdeepfm_forward(model: XDeepFM, fields: torch.Tensor) -> torch.Tensor:
    """fields (B, n_fields) per-field row index -> logits (B,).

    The CIN: layer k forms z[b, d, (h, j)] = xk[b, h, d] · x0[b, j, d] and
    contracts it with W_k (H_{k+1}, H_k·m) as one matrix product over the
    (h, j) axis. JAX builds z as (B, H_k·m, D) and contracts with an einsum;
    the port builds it d-major, (B, D, H_k·m), so that the product is one
    (B·D, H_k·m) @ (H_k·m, H_{k+1}) with no copy of z: the same sums, in
    another order. Live per layer: z, B·D·H_k·m values (312,000 bytes a row
    at the full config's H_k = 200, m = 39, D = 10, f32), which autograd
    keeps for W_k's gradient; x0 and xk are (B, m|H, D)."""
    cfg = model.cfg
    b, m = fields.shape
    offsets = torch.arange(m, dtype=fields.dtype,
                           device=fields.device) * cfg.field_vocab
    flat_idx = fields + offsets[None, :]
    emb = F.embedding(flat_idx, model.table)  # (B, m, D)

    x0 = emb.transpose(1, 2)  # (B, D, m)
    xk = x0
    pools = []
    for w in model.cin:
        z = (xk[..., :, None] * x0[..., None, :]).reshape(
            b, cfg.embed_dim, -1)  # (B, D, H_k·m)
        xk = z @ w.T  # (B, D, H_{k+1})
        pools.append(xk.sum(dim=1))  # (B, H_{k+1})
    cin_logit = (torch.cat(pools, dim=-1) @ model.cin_out)[:, 0]

    dnn_logit = model.dnn(emb.reshape(b, -1), F.relu)[:, 0]
    lin_logit = F.embedding(flat_idx, model.linear)[..., 0].sum(-1)
    return cin_logit + dnn_logit + lin_logit + model.bias


def xdeepfm_loss(model: XDeepFM, batch: dict):
    dev = model.table.device
    logit = xdeepfm_forward(model, as_tensor(batch["fields"], dev))
    loss = _bce(logit, as_tensor(batch["label"], dev))
    return loss, {"loss": loss}


def xdeepfm_score_candidates(model: XDeepFM, user_fields: torch.Tensor,
                             cand_fields: torch.Tensor,
                             chunk: int = 100_000) -> torch.Tensor:
    """user_fields (1, m-k); cand_fields (N, k) -> (N,) scores. When N >
    ``chunk`` and N % chunk == 0, the candidates go in chunks of ``chunk``
    (JAX's ``lax.map``): peak memory is one chunk's CIN. Otherwise one
    pass."""
    n = cand_fields.shape[0]
    uf = user_fields.expand(n, user_fields.shape[1])
    fields = torch.cat([uf, cand_fields.to(uf.dtype)], dim=-1)
    if n % chunk or n <= chunk:
        return xdeepfm_forward(model, fields)
    return torch.cat([xdeepfm_forward(model, f)
                      for f in fields.split(chunk)])
