"""The LM train step's forward and backward on the weights' blocks of a
(data, model) mesh: ZeRO-3 gathers over the data axes a layer at a time,
tensor-parallel products on the "model" axis, and the MoE routed over the
global batch. The port's own module: JAX leaves all of this to GSPMD.

Each data row (the rows of the batch one data coordinate holds, on the
device of its first position) keeps its residual stream whole. Model shard
m of that row (the position with the row's data coordinates and model
coordinate m) computes its part of each layer, and every row and shard of
a layer is formed before the next layer:

* **ZeRO-3.** A weight's block of shard m is assembled from the blocks
  that hold it (:meth:`Shards.tensor`, a ``torch.cat``, so autograd sums
  the rows' uses back into each block: the reduce-scatter). The autograd
  leaves are the placed blocks themselves, one a unique block (replicas
  read the first copy), so no whole replica of the weights is gathered.
  Under ``remat`` the gathers sit inside each block's checkpoint and run
  again in the backward.
* **Attention.** ``wq``, ``wk`` and ``wv`` are column-parallel (shard m
  owns H/M query heads and Hkv/M kv heads; its qk-norm and RoPE are per
  head), the hand-written ``flash_attention`` runs on each shard's heads,
  and ``wo`` is row-parallel. When the kv heads do not split over the
  shards (MQA), k and v are formed whole on the row and each shard takes
  the kv head of each of its query heads. When the query heads do not
  split, or the attention is MLA, it runs whole on the row (every weight
  gathered over both axes).
* **FFN.** ``w_gate`` and ``w_up`` column-parallel, ``w_down``
  row-parallel.
* **The tied head.** Where the vocab splits over "model", shard m forms
  the logits of its vocab block (sequence chunks as
  ``transformer.chunked_cross_entropy``): the log-sum-exp is taken over the
  shards', and the label's logit comes from the shard that owns it. The
  input embedding is vocab-parallel the same way. Else the head is whole.
* **MoE.** The routing layout is the global batch's
  (``moe.row_layout``); a row holds whole groups, so each row dispatches
  its own. With the experts over "model" (E divides it), shard m runs its
  experts over the row's capacity rows and their outputs return to the
  row for the combine; with the experts' width over "model", the three
  products are column- then row-parallel. The aux and z losses come from
  each row's counts and sums (``moe.aux_terms``).

A row-parallel product's partials are formed in f32 on each shard and
summed over "model" on the row's device in shard order, then cast (the
all-reduce); a column-parallel product's input gradients are summed the
same way in the backward. So in bf16 a product rounds once, as the
unsharded product does.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import Placed, _axes
from repro_torch.models import layers, moe
from repro_torch.models import transformer as T

MODEL = "model"


def _mm32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with an f32 result (2-D, or batched 3-D): a 16-bit pair
    on the card through cuBLAS with an f32 output, elsewhere upcast (the
    same products, exact in f32)."""
    if a.dtype == torch.float32:
        return torch.matmul(a, b)
    if a.is_cuda:
        mm = torch.bmm if a.dim() == 3 else torch.mm
        return mm(a, b, out_dtype=torch.float32)
    return torch.matmul(a.float(), b.float())


def _t(w: torch.Tensor) -> torch.Tensor:
    return w.transpose(-1, -2)


class _ColumnParallel(torch.autograd.Function):
    """x (N, k) on the row's device times each shard's column block w_m
    (k, n_m): ``x @ w_m`` on w_m's device for each m. The backward sums the
    shards' input gradients over "model" in f32, in shard order, on x's
    device, then casts. Batched: x (E, N, k), w_m (E, k, n_m)."""

    @staticmethod
    def forward(ctx, x, *ws):
        xs = [x.to(w.device) for w in ws]
        ctx.save_for_backward(*xs, *ws)
        ctx.home = (x.device, x.dtype)
        return tuple(xm @ w for xm, w in zip(xs, ws))

    @staticmethod
    def backward(ctx, *gs):
        saved, n = ctx.saved_tensors, len(gs)
        xs, ws = saved[:n], saved[n:]
        dev, dtype = ctx.home
        dx = None
        if ctx.needs_input_grad[0]:
            for g, w in zip(gs, ws):
                if g is None:
                    continue
                part = _mm32(g, _t(w)).to(dev)
                dx = part if dx is None else dx + part
            dx = None if dx is None else dx.to(dtype)
        dws = [_t(xm) @ g if (g is not None and ctx.needs_input_grad[1 + i])
               else None for i, (xm, g) in enumerate(zip(xs, gs))]
        return (dx, *dws)


class _RowParallel(torch.autograd.Function):
    """``Σ_m h_m @ w_m`` over "model": each shard's partial in f32, moved
    to ``dev``, summed in shard order, then cast to h's dtype. The
    backward copies the output's gradient to each shard."""

    @staticmethod
    def forward(ctx, dev, *hw):
        hs, ws = hw[0::2], hw[1::2]
        ctx.save_for_backward(*hw)
        acc = None
        for h, w in zip(hs, ws):
            part = _mm32(h, w).to(dev)
            acc = part if acc is None else acc + part
        return acc.to(hs[0].dtype)

    @staticmethod
    def backward(ctx, gy):
        hw = ctx.saved_tensors
        out = [None]
        for i in range(0, len(hw), 2):
            h, w = hw[i], hw[i + 1]
            g = gy.to(h.device)
            out.append(g @ _t(w) if ctx.needs_input_grad[1 + i] else None)
            out.append(_t(h) @ g if ctx.needs_input_grad[2 + i] else None)
        return tuple(out)


def column(x: torch.Tensor, ws) -> tuple[torch.Tensor, ...]:
    """Column-parallel products of ``x`` with each shard's block (one
    shard: the plain product)."""
    if len(ws) == 1:
        return (x.to(ws[0].device) @ ws[0],)
    return _ColumnParallel.apply(x, *ws)


def row(dev, hs, ws) -> torch.Tensor:
    """Row-parallel product summed over the shards onto ``dev`` (one
    shard: the plain product)."""
    if len(ws) == 1:
        return (hs[0] @ ws[0]).to(dev)
    return _RowParallel.apply(dev, *(t for pair in zip(hs, ws) for t in pair))


def _assemble(items, device):
    """The tensor tiled by ``items`` ([(global slices, block)]), each
    block moved to ``device``, concatenated along each split dimension."""
    if len(items) == 1:
        return items[0][1].to(device)
    ndim = len(items[0][0])
    dim = next(d for d in range(ndim)
               if len({sl[d].start for sl, _ in items}) > 1)
    starts = sorted({sl[dim].start for sl, _ in items})
    return torch.cat([_assemble([it for it in items if it[0][dim].start == s],
                                device) for s in starts], dim=dim)


class Shards:
    """The step's view of the placed weights: each unique block (replica
    0) as an autograd leaf that shares its storage, and each weight's
    block of a model shard assembled from them."""

    def __init__(self, mesh, params: dict[str, Placed]):
        self.mesh = mesh
        self.m = mesh.shape.get(MODEL, 1)
        self.axis = (mesh.axis_names.index(MODEL) if MODEL in mesh.shape
                     else None)
        self.params = params
        self.leaves: dict[str, list] = {}
        for name, x in params.items():
            sh = x.sharding
            for e in sh.spec:
                if MODEL in _axes(e) and len(_axes(e)) > 1:
                    raise NotImplementedError(
                        f"{name}: a dimension split over {_axes(e)}; the "
                        "tensor-parallel step takes \"model\" alone")
            self.leaves[name] = [
                (pos, sh.block_slices(x.shape, pos),
                 blk.detach().requires_grad_())
                for pos, blk in zip(self.mesh.positions(), x.blocks)
                if sh.replica_id(pos) == 0]

    def split_dim(self, name: str) -> int | None:
        """The dimension of ``name`` split over "model" (None if none)."""
        for d, e in enumerate(self.params[name].sharding.spec):
            if MODEL in _axes(e):
                return d
        return None

    def tensor(self, name: str, m: int, device) -> torch.Tensor:
        """Shard m's block of ``name``: its slice of the dimension over
        "model", whole along every other one (gathered over the data
        axes), on ``device``."""
        split = self.split_dim(name) is not None
        want = m if split else 0
        return _assemble([(sl, leaf) for pos, sl, leaf in self.leaves[name]
                          if self.axis is None or pos[self.axis] == want],
                         device)

    def whole(self, name: str, device) -> torch.Tensor:
        """The whole tensor, gathered over every axis, on ``device``."""
        return _assemble([(sl, leaf) for _, sl, leaf in self.leaves[name]],
                         device)

    def grads(self, grads_of_leaves: dict) -> dict[str, tuple]:
        """Each weight's gradient a mesh position (its sharding's layout;
        a replica gets its first copy's), zeros where the loss does not
        reach it."""
        out = {}
        for name, x in self.params.items():
            by_slices = {}
            for (_, sl, leaf), g in zip(self.leaves[name],
                                        grads_of_leaves[name]):
                key = tuple((s.start, s.stop) for s in sl)
                by_slices[key] = torch.zeros_like(leaf) if g is None else g
            sh = x.sharding
            out[name] = tuple(
                by_slices[tuple((s.start, s.stop) for s in sh.block_slices(
                    x.shape, pos))].to(blk.device)
                for pos, blk in zip(self.mesh.positions(), x.blocks))
        return out


class Row:
    """One data row: its rows of the batch, their count, and the device of
    each model shard (``devices[0]``: the row's own)."""

    def __init__(self, mesh, pos, batch: dict, n: int):
        self.batch, self.n = batch, n
        if MODEL in mesh.shape:
            k = mesh.axis_names.index(MODEL)
            self.devices = tuple(
                mesh.device_at(pos[:k] + (m,) + pos[k + 1:])
                for m in range(mesh.shape[MODEL]))
        else:
            self.devices = (mesh.device_at(pos),)

    @property
    def dev(self) -> torch.device:
        return self.devices[0]


class _Bound(nn.Module):
    """``fn(module, *args)`` as a module's forward, for ``functional_call``
    of a method other than ``forward``."""

    def __init__(self, module: nn.Module, fn):
        super().__init__()
        self.mod, self.fn = module, fn

    def forward(self, *args):
        return self.fn(self.mod, *args)


def _whole_call(sh: Shards, module: nn.Module, prefix: str, dev, fn, *args):
    """``fn(module, *args)`` on the row with every weight of ``module``
    gathered whole (the template module holds no storage)."""
    weights = {f"mod.{n}": sh.whole(prefix + n, dev)
               for n, _ in module.named_parameters()}
    return functional_call(_Bound(module, fn), weights, args)


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------
def _per_shard(sh: Shards, name: str, r: Row):
    return [sh.tensor(name, m, d) for m, d in enumerate(r.devices)]


def embed(sh: Shards, cfg, tokens: torch.Tensor, r: Row) -> torch.Tensor:
    """``Transformer.embed_tokens``: vocab-parallel where the table's vocab
    lies over "model" (each shard looks up the ids it owns, the others give
    exact zeros, summed in f32), else the whole table."""
    ids = T.lookup_ids(tokens.to(r.dev), cfg.vocab)
    if sh.m == 1 or sh.split_dim("embed") != 0:
        return sh.whole("embed", r.dev)[ids].to(cfg.dtype)
    acc = None
    for m, tab in enumerate(_per_shard(sh, "embed", r)):
        n = tab.shape[0]
        loc = ids.to(tab.device) - m * n
        own = ((loc >= 0) & (loc < n))[..., None]
        x = torch.where(own, tab[loc.clamp(0, n - 1)], 0.0).float().to(r.dev)
        acc = x if acc is None else acc + x
    return acc.to(cfg.dtype)


def attention(sh: Shards, cfg, attn: nn.Module, pre: str, h: torch.Tensor,
              positions: torch.Tensor, r: Row) -> torch.Tensor:
    """``Attention.forward`` (``MLAAttention.forward_kv``'s output) of
    h (B, S, d) with each model shard on its own heads."""
    b, s, d = h.shape
    hh, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if (cfg.mla or sh.m == 1 or hh % sh.m
            or sh.split_dim(pre + "wq") != 1 or sh.split_dim(pre + "wo") != 0):
        return _whole_call(sh, attn, pre, r.dev,
                           lambda mod, x, p: mod.forward_kv(x, p)[0],
                           h, positions)
    hq = hh // sh.m
    x2 = h.reshape(b * s, d)
    qs = column(x2, _per_shard(sh, pre + "wq", r))
    kv_split = (hk % sh.m == 0 and sh.split_dim(pre + "wk") == 1
                and sh.split_dim(pre + "wv") == 1)
    if kv_split:
        ks = column(x2, _per_shard(sh, pre + "wk", r))
        vs = column(x2, _per_shard(sh, pre + "wv", r))
    else:
        # the kv columns do not hold whole heads a shard: k and v whole on
        # the row, each shard reading its query heads' kv heads
        k_all = (x2 @ sh.whole(pre + "wk", r.dev)).view(b, s, hk, hd)
        v_all = (x2 @ sh.whole(pre + "wv", r.dev)).view(b, s, hk, hd)
        if cfg.qk_norm:
            k_all = layers.rms_norm(k_all, sh.whole(pre + "k_norm", r.dev))
        k_all = layers.apply_rope(k_all, positions, cfg.rope_theta)
    outs = []
    for m, dev in enumerate(r.devices):
        pos = positions.to(dev)
        q = qs[m].view(b, s, hq, hd)
        if cfg.qk_norm:
            q = layers.rms_norm(q, sh.whole(pre + "q_norm", dev))
        q = layers.apply_rope(q, pos, cfg.rope_theta)
        if kv_split:
            k = ks[m].view(b, s, hk // sh.m, hd)
            v = vs[m].view(b, s, hk // sh.m, hd)
            if cfg.qk_norm:
                k = layers.rms_norm(k, sh.whole(pre + "k_norm", dev))
            k = layers.apply_rope(k, pos, cfg.rope_theta)
        else:
            idx = torch.tensor([(m * hq + j) // (hh // hk) for j in range(hq)],
                               device=r.dev)
            k = k_all.index_select(2, idx).to(dev)
            v = v_all.index_select(2, idx).to(dev)
        o = layers.blockwise_attention(q, k, v, causal=True,
                                       block_kv=cfg.block_kv)
        outs.append(o.reshape(b * s, hq * hd))
    return row(r.dev, outs, _per_shard(sh, pre + "wo", r)).view(b, s, d)


def ffn(sh: Shards, pre: str, h: torch.Tensor, r: Row) -> torch.Tensor:
    """``layers.swiglu`` of h (..., d): ``w_gate`` and ``w_up``
    column-parallel, ``w_down`` row-parallel (whole on the row when its
    width does not split over "model")."""
    d = h.shape[-1]
    if (sh.m == 1 or sh.split_dim(pre + "w_gate") != 1
            or sh.split_dim(pre + "w_down") != 0):
        return layers.swiglu(h, *(sh.whole(pre + n, r.dev)
                                  for n in ("w_gate", "w_up", "w_down")))
    x2 = h.reshape(-1, d)
    gs = column(x2, _per_shard(sh, pre + "w_gate", r))
    us = column(x2, _per_shard(sh, pre + "w_up", r))
    hs = [F.silu(g.float()).to(h.dtype) * u for g, u in zip(gs, us)]
    return row(r.dev, hs, _per_shard(sh, pre + "w_down", r)).view(h.shape)


def _experts(sh: Shards, pre: str, buf: torch.Tensor, r: Row) -> torch.Tensor:
    """``moe.experts`` of one row's (E, rows, d) buffer where the expert
    stacks lie: by experts over "model" (each shard runs its experts, the
    outputs return to the row), by width over "model" (column- then
    row-parallel), or whole."""
    names = [pre + n for n in ("w_gate", "w_up", "w_down")]
    split = sh.split_dim(names[0])
    if sh.m > 1 and split == 0:
        e = buf.shape[0] // sh.m
        outs = []
        for m, dev in enumerate(r.devices):
            ws = [sh.tensor(n, m, dev) for n in names]
            outs.append(moe.experts(buf[m * e:(m + 1) * e].to(dev), *ws)
                        .to(r.dev))
        return torch.cat(outs)
    if sh.m > 1 and split == 2 and sh.split_dim(names[2]) == 1:
        gs = column(buf, _per_shard(sh, names[0], r))
        us = column(buf, _per_shard(sh, names[1], r))
        hs = [F.silu(g.float()).to(buf.dtype) * u for g, u in zip(gs, us)]
        return row(r.dev, hs, _per_shard(sh, names[2], r))
    return moe.experts(buf, *(sh.whole(n, r.dev) for n in names))


def moe_rows(sh: Shards, cfg, pre: str, hs, rows):
    """``moe.moe_ffn`` over every row's tokens at once: the global batch's
    routing layout, each row dispatching its whole groups, the aux and z
    losses from the rows' counts and sums. (ys, aux, z, dropped): dropped
    counts the (token, slot) assignments past the capacity."""
    mc = cfg.moe_cfg()
    e = mc.n_experts
    n_tok = sum(h.shape[0] * h.shape[1] for h in hs)
    g, cap = moe.row_layout(mc, n_tok, len(rows))
    n_buf = e * g * cap
    ys, terms, dropped = [], [], None
    for h, r in zip(hs, rows):
        xt = h.reshape(-1, h.shape[-1])
        logits, probs, top_p, top_e, slot = moe.plan(
            sh.whole(pre + "router", r.dev), xt, mc, g, cap)
        out = _experts(sh, pre, moe.dispatch(xt, slot, e, n_buf), r)
        y = moe.combine(out, slot, top_p)
        if mc.n_shared:
            y = y + ffn(sh, pre + "shared.", xt, r)
        ys.append(y.view(h.shape))
        terms.append(moe.aux_terms(logits, probs, top_e))
        drop = (slot >= n_buf).sum().to(rows[0].dev)
        dropped = drop if dropped is None else dropped + drop
    aux, z = moe.aux_from_rows(terms, n_tok)
    return ys, aux, z, dropped


def _block(sh: Shards, cfg, blk: nn.Module, pre: str, rows, *xs):
    """``Block.forward`` of every row's x: (*new xs, aux, z, dropped),
    the last three None in a dense block."""
    mid = []
    for x, r in zip(xs, rows):
        pos = torch.arange(x.shape[1], device=r.dev)
        h = layers.rms_norm(x, sh.whole(pre + "ln1", r.dev))
        mid.append(x + attention(sh, cfg, blk.attn, pre + "attn.", h, pos, r))
    hs = [layers.rms_norm(x, sh.whole(pre + "ln2", r.dev))
          for x, r in zip(mid, rows)]
    if not blk.use_moe:
        return (*(x + ffn(sh, pre + "ffn.", h, r)
                  for x, h, r in zip(mid, hs, rows)), None, None, None)
    ys, aux, z, dropped = moe_rows(sh, cfg, pre + "moe.", hs, rows)
    return (*(x + y for x, y in zip(mid, ys)), aux, z, dropped)


def _nll_sum(h: torch.Tensor, labels: torch.Tensor, *tables) -> torch.Tensor:
    """The summed cross entropy of h (..., d) against the tied head, the
    vocab in ``tables`` (each shard's block, in vocab order)."""
    if len(tables) == 1:
        return T._nll(h @ tables[0].to(h.device).T, labels).sum()
    dev, d = h.device, h.shape[-1]
    lab = labels.reshape(-1).long()
    logits = column(h.reshape(-1, d), [t.T for t in tables])
    lses, gold, off = [], None, 0
    for lg, tab in zip(logits, tables):
        n = tab.shape[0]
        lf = lg.float()
        lses.append(torch.logsumexp(lf, dim=-1).to(dev))
        loc = lab.to(lf.device) - off
        own = (loc >= 0) & (loc < n)
        g = lf.gather(-1, loc.clamp(0, n - 1)[:, None])[:, 0]
        g = torch.where(own, g, 0.0).to(dev)
        gold = g if gold is None else gold + g
        off += n
    return (torch.logsumexp(torch.stack(lses, -1), dim=-1) - gold).sum()


def cross_entropy(sh: Shards, cfg, hidden: torch.Tensor,
                  labels: torch.Tensor, r: Row, chunked: bool) -> torch.Tensor:
    """``transformer``'s cross entropy against the tied head (in sequence
    chunks of ``cfg.ce_chunk`` when ``chunked``, each recomputed in the
    backward), vocab-parallel where the table's vocab lies over "model"."""
    if sh.m > 1 and sh.split_dim("embed") == 0:
        tables = _per_shard(sh, "embed", r)
    else:
        tables = [sh.whole("embed", r.dev)]
    labels = labels.to(r.dev)
    b, s, _ = hidden.shape
    chunk = min(cfg.ce_chunk, s) if chunked else s
    remat = chunked and torch.is_grad_enabled()
    total = torch.zeros((), dtype=torch.float32, device=r.dev)
    for lo in range(0, s, chunk):
        args = (hidden[:, lo:lo + chunk], labels[:, lo:lo + chunk], *tables)
        total = total + (checkpoint(_nll_sum, *args, use_reentrant=False)
                         if remat else _nll_sum(*args))
    return total / (b * s)


def lm_loss(template: T.Transformer, sh: Shards, rows) -> tuple:
    """``transformer.loss_fn`` of the whole batch, every row's layers run
    together: (total, {"ce", "aux", "z", ["mtp_ce",] "loss", "dropped"})
    on the first row's device. The rows' cross entropies (means over their
    positions) are weighted by their share of the batch."""
    cfg = template.cfg
    dev0, n_all = rows[0].dev, sum(r.n for r in rows)
    toks = [r.batch["tokens"].to(r.dev) for r in rows]
    use_chunked = bool(cfg.ce_chunk) and toks[0].shape[1] > cfg.ce_chunk
    xs = [embed(sh, cfg, t, r) for t, r in zip(toks, rows)]
    remat = cfg.remat != "none" and torch.is_grad_enabled()
    aux = z = torch.zeros((), dtype=torch.float32, device=dev0)
    dropped = []
    for i, blk in enumerate(template.blocks):
        fn = functools.partial(_block, sh, cfg, blk, f"blocks.{i}.", rows)
        *xs, a, zz, dr = (checkpoint(fn, *xs, use_reentrant=False)
                          if remat else fn(*xs))
        if a is not None:
            aux, z = aux + a, z + zz
            dropped.append(dr)
    hidden = [layers.rms_norm(x, sh.whole("final_norm", r.dev))
              for x, r in zip(xs, rows)]

    def weighted(terms):
        return sum((r.n / n_all) * t.to(dev0) for t, r in zip(terms, rows))

    ce = weighted([cross_entropy(sh, cfg, h, r.batch["labels"], r,
                                 use_chunked) for h, r in zip(hidden, rows)])
    total = ce + cfg.aux_loss_coef * aux + cfg.z_loss_coef * z
    metrics = {"ce": ce, "aux": aux, "z": z}
    if cfg.mtp:
        # as loss_fn: one extra block predicts token t+2 from
        # [h_t ; emb(token_{t+1})]
        hm = [torch.cat([h[:, :-1], embed(sh, cfg, t[:, 1:], r)], dim=-1)
              @ sh.whole("mtp.proj", r.dev)
              for h, t, r in zip(hidden, toks, rows)]
        hm = _block(sh, cfg, template.mtp.block, "mtp.block.", rows, *hm)
        mtp_ce = weighted([cross_entropy(
            sh, cfg, layers.rms_norm(x, sh.whole("mtp.norm", r.dev)),
            r.batch["labels"][:, 1:], r, use_chunked)
            for x, r in zip(hm[:len(rows)], rows)])
        total = total + cfg.mtp_coef * mtp_ce
        metrics["mtp_ce"] = mtp_ce
    metrics["loss"] = total
    metrics["dropped"] = (torch.stack(dropped) if dropped
                          else torch.zeros(0, dtype=torch.int64, device=dev0))
    return total, metrics


def lm_loss_and_grads(template: T.Transformer, params: dict[str, Placed],
                      rows, mesh):
    """The LM's loss on the placed weights and one backward: (loss, each
    weight's gradient a mesh position in its sharding's layout, the loss's
    metrics, detached). ``rows``: ``[(position, {key: rows}, n)]`` of the
    batch, one a data row."""
    sh = Shards(mesh, params)
    rows = [Row(mesh, pos, b, n) for pos, b, n in rows]
    loss, metrics = lm_loss(template, sh, rows)
    leaves = [leaf for name in params for _, _, leaf in sh.leaves[name]]
    flat = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(flat)
    grads = sh.grads({name: [next(it) for _ in sh.leaves[name]]
                      for name in params})
    return loss.detach(), grads, {k: v.detach() for k, v in metrics.items()}
