"""Gather → score and pool-merge kernels of the bi-metric beam step.

Three hand-written Hopper kernels (``csrc/l2_topk.cu``, CUDA C++ for
``sm_90a``), each with its plain PyTorch version beside it:

* :func:`gather_score` replaces the Pallas ``repro.kernels.l2_topk.
  gather_score``: per (query b, lane k) it scores ``corpus[ids[b, k]]``
  against query b. Bound by the bytes of the gathered rows
  (``B·K·dim·itemsize`` over the card's 3.35 TB/s). One warp per lane, the
  query staged in shared memory, 16-byte row loads, f32 accumulation in a
  fixed order and a fixed shuffle tree, so a lane's value depends only on
  its (query, row) pair.
* :func:`gather_score_local` replaces the Pallas ``gather_score_local``:
  the shard-local twin over one contiguous block of rows. Owned lanes run
  the same lane body as :func:`gather_score` on the local row, so they
  equal it bit for bit; foreign and padding lanes give 0.0 and load no row.
  Bound by the owned lanes' rows. Each block compacts the owned lanes of a
  chunk of up to 256 and stages its query only when it owns one.
* :func:`beam_merge_topk` / :func:`merge_pool_batch` replace the Pallas
  ``beam_merge_topk``: per row the best P of (pool ‖ candidates) on the key
  (distance, input position) in shared memory — stable, so it equals
  ``ref.merge_pool_batch_ref`` exactly. A sorted pool (every pool the
  engine hands in) is merged with the sorted candidates by rank; any other
  pool runs a full bitonic sort, chosen inside the kernel from the data.
  Bound by the row's bytes.

Dispatch is by device only: a CUDA tensor launches the kernel (or raises),
a CPU tensor runs the plain version. Each launch adds one to
:data:`launches`.
"""
from __future__ import annotations

import contextlib
import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.backend import CorpusView

VALID_METRICS = ("l2", "sqeuclidean", "ip", "cosine")
_METRIC_CODE = {"l2": 0, "sqeuclidean": 1, "ip": 2, "cosine": 3}
_ROW_TYPE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
             torch.int8: 3, torch.float8_e4m3fn: 4, torch.float8_e5m2: 5}

#: most merge lanes: 8-byte keys in dynamic shared memory (128 KB)
MAX_MERGE_PAD = 16384
#: largest query staged in shared memory without opting in (48 KB of f32)
MAX_GATHER_DIM = 12288

#: kernel launches since the last :func:`reset_launches`, by kernel name
launches = {"gather_score": 0, "gather_score_local": 0,
            "beam_merge_topk": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


_typed_lib = None


def _lib():
    global _typed_lib
    if _typed_lib is not None:
        return _typed_lib
    from repro_torch.kernels import _build

    lib = _build.load("l2_topk")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gather_score_launch.argtypes = [p, i, p, i, i, p, p, p, i, i, i,
                                            i, i, i, p]
        lib.gather_score_launch.restype = i
        lib.gather_score_local_launch.argtypes = [p, i, p, i, i, p, p, p, i,
                                                  i, i, i, i, i, i, p]
        lib.gather_score_local_launch.restype = i
        lib.beam_merge_launch.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i,
                                          p]
        lib.beam_merge_launch.restype = i
        lib._typed = True
    _typed_lib = lib
    return lib


def _stream(t: torch.Tensor) -> int:
    """The raw handle of the current stream on ``t``'s card."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


_NO_SWITCH = contextlib.nullcontext()


def _on(t: torch.Tensor):
    """The device context of a launch on ``t``: nothing when ``t``'s card is
    already the current one (the common case; a switch costs host time on
    every call), else a switch to it for the launch."""
    i = t.get_device()
    return _NO_SWITCH if i == torch.cuda.current_device() else torch.cuda.device(i)


def _f32(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.float32 and x.is_contiguous():
        return x
    return x.float().contiguous()


def _check_layout(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor of shape {tuple(t.shape)} is "
                             "not contiguous")


def _raise_on(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def _refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise when autograd would record a card route that has no backward.

    A kernel fills its output through ctypes, out of autograd's sight, so
    a gradient through it would be lost without a word. Call it before the
    output is allocated; the plain versions on the CPU are differentiable
    and never call it.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward yet, and an input "
            "requires grad; run it under torch.inference_mode() or "
            "torch.no_grad(), or pass detached inputs")


# --------------------------------------------------------------------------
# gather → score
# --------------------------------------------------------------------------
def pack_row_meta(view: CorpusView) -> torch.Tensor:
    """(N, 2) ``[‖x‖², 1/‖x‖]`` or (N, 4) ``[.., scale, zero_point]`` f32.

    The zero-point column is 0.0 for the symmetric fp8 modes, so one
    ``(code - zp) * scale`` dequant serves int8 and fp8 alike.
    """
    cols = [view.sq_norms, view.inv_norms]
    if view.scales is not None:
        cols.append(view.scales.float())
        zp = view.zero_points
        cols.append(torch.zeros_like(cols[-1]) if zp is None else zp.float())
    return torch.stack(cols, dim=1).contiguous()


def pack_norms(view: CorpusView) -> torch.Tensor:
    """(N, 2) f32 ``[‖x‖², 1/‖x‖]``: :func:`pack_row_meta` of an unquantized
    view (the JAX package's historical norms operand)."""
    return torch.stack([view.sq_norms, view.inv_norms], dim=1).contiguous()


def gather_score_plain(rows: torch.Tensor, queries: torch.Tensor,
                       ids: torch.Tensor, *, metric: str = "sqeuclidean",
                       meta: torch.Tensor | None = None,
                       matmul: bool = False) -> torch.Tensor:
    """The plain PyTorch version of :func:`gather_score` (same arguments)."""
    quant = meta is not None and meta.shape[1] == 4
    if not matmul:
        if quant:
            return ref.gather_score_quant_ref(rows, meta[:, 2], meta[:, 3],
                                              queries, ids, metric=metric)
        return ref.gather_score_ref(rows, queries, ids, metric=metric)
    safe = ids.clamp(min=0).long()
    if quant:
        g = ref.dequant_rows_ref(rows[safe], meta[:, 2][safe],
                                 meta[:, 3][safe])
    else:
        g = rows[safe].float()  # (B, K, dim)
    q = queries.float()
    dots = torch.einsum("bkd,bd->bk", g, q)
    qsq = (q * q).sum(-1)
    m = meta[safe]
    if metric in ("l2", "sqeuclidean"):
        d = torch.clamp(m[..., 0] - 2.0 * dots + qsq[:, None], min=0.0)
        if metric == "l2":
            d = torch.sqrt(d)
    elif metric == "ip":
        d = -dots
    else:
        d = 1.0 - dots * torch.rsqrt(qsq + 1e-12)[:, None] * m[..., 1]
    return torch.where(ids >= 0, d, torch.full_like(d, float("inf")))


def _check_gather(name, rows, queries, ids, metric, meta, matmul):
    """Validate a gather's arguments -> (f32 contiguous queries, dim, b, k)."""
    if metric not in VALID_METRICS:
        raise ValueError(f"metric must be one of {VALID_METRICS}, got {metric!r}")
    if matmul and meta is None:
        raise ValueError(f"{name}(matmul=True) needs the row metadata")
    if meta is not None and meta.shape[1] not in (2, 4):
        raise ValueError(f"meta must have 2 or 4 columns, got {meta.shape}")
    if rows.dtype not in _ROW_TYPE:
        raise ValueError(f"{name}: unsupported row dtype {rows.dtype}")
    if ids.dtype != torch.int32:
        raise ValueError(f"{name}: ids must be int32, got {ids.dtype}")
    n, dim = rows.shape
    b, k = ids.shape
    if queries.shape != (b, dim):
        raise ValueError(f"{name}: queries {tuple(queries.shape)} do not "
                         f"match ids {tuple(ids.shape)} and dim {dim}")
    if meta is not None and (meta.dtype != torch.float32 or meta.shape[0] != n):
        raise ValueError(f"{name}: meta must be (rows, 2|4) float32")
    queries = _f32(queries)
    _check_layout(name, rows, queries, ids,
                  *([meta] if meta is not None else []))
    if rows.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {rows.device}")
    if rows.device.type == "cuda" and dim > MAX_GATHER_DIM:
        raise ValueError(f"{name}: dim {dim} > {MAX_GATHER_DIM}")
    return queries, dim, b, k


def _vec(name: str, rows: torch.Tensor) -> int:
    """The 16-byte row-load path, chosen from (dim, dtype) alone.

    The vector and scalar paths split a row across the warp differently, so
    their sums differ in the last bits. A shard's block starts wherever its
    rows do; choosing by address would let two shards of one corpus take
    different paths. A misaligned base therefore raises.
    """
    vec = rows.shape[1] % (16 // rows.element_size()) == 0
    if vec and rows.data_ptr() % 16:
        raise ValueError(f"{name}: rows at address {rows.data_ptr():#x} are "
                         "not 16-byte aligned")
    return int(vec)


def gather_score(rows: torch.Tensor, queries: torch.Tensor, ids: torch.Tensor,
                 *, metric: str = "sqeuclidean",
                 meta: torch.Tensor | None = None,
                 matmul: bool = False) -> torch.Tensor:
    """rows (N, dim); queries (B, dim); ids (B, K) int32 -> (B, K) f32.

    ids < 0 are padding and score +inf. ``meta`` is :func:`pack_row_meta`
    of the rows' view: with ``matmul`` the norm-cache form runs (``meta``
    required), without it the gather-then-reduce form; a 4-column ``meta``
    dequantizes int8/fp8 codes in registers in either form.
    """
    queries, dim, b, k = _check_gather("gather_score", rows, queries, ids,
                                       metric, meta, matmul)
    if rows.device.type == "cpu":
        return gather_score_plain(rows, queries, ids, metric=metric,
                                  meta=meta, matmul=matmul)
    vec = _vec("gather_score", rows)
    out = torch.empty((b, k), dtype=torch.float32, device=rows.device)
    with _on(rows):
        err = _lib().gather_score_launch(
            rows.data_ptr(), _ROW_TYPE[rows.dtype],
            meta.data_ptr() if meta is not None else None,
            meta.shape[1] if meta is not None else 0, int(matmul),
            queries.data_ptr(), ids.data_ptr(), out.data_ptr(), b, k,
            rows.shape[0], dim, _METRIC_CODE[metric], vec,
            _stream(rows))
    _raise_on("gather_score", err)
    launches["gather_score"] += 1
    return out


def gather_l2(corpus: torch.Tensor, queries: torch.Tensor,
              ids: torch.Tensor) -> torch.Tensor:
    """corpus (N, dim); queries (B, dim); ids (B, K) int32 -> (B, K) squared
    l2: the historical sqeuclidean entry of :func:`gather_score`."""
    return gather_score(corpus, queries, ids, metric="sqeuclidean")


def gather_score_local_plain(rows: torch.Tensor, queries: torch.Tensor,
                             ids: torch.Tensor, offset: int, *,
                             metric: str = "sqeuclidean",
                             meta: torch.Tensor | None = None,
                             matmul: bool = False) -> torch.Tensor:
    """The plain PyTorch version of :func:`gather_score_local`."""
    if not matmul:
        if meta is not None and meta.shape[1] == 4:
            return ref.gather_score_local_quant_ref(
                rows, meta[:, 2], meta[:, 3], queries, ids, offset,
                metric=metric)
        return ref.gather_score_local_ref(rows, queries, ids, offset,
                                          metric=metric)
    owned, loc = ref.owned_local(ids, offset, rows.shape[0])
    d = gather_score_plain(rows, queries, loc, metric=metric, meta=meta,
                           matmul=True)
    return torch.where(owned, d, torch.zeros_like(d))


def gather_score_local(rows: torch.Tensor, queries: torch.Tensor,
                       ids: torch.Tensor, offset: int, *,
                       metric: str = "sqeuclidean",
                       meta: torch.Tensor | None = None,
                       matmul: bool = False) -> torch.Tensor:
    """Shard-local :func:`gather_score` over global ids -> (B, K) partials.

    ``rows`` (n_local, dim) is one shard's block, global rows
    ``[offset, offset + n_local)``; ``meta`` its :func:`pack_row_meta`. A
    lane is owned iff ``0 <= ids - offset < n_local``: owned lanes carry
    exactly the value :func:`gather_score` gives on that row, every other
    lane (foreign or padding) 0.0, so the sum over shards is the unsharded
    wave with its padding lanes at 0.0.
    """
    queries, dim, b, k = _check_gather("gather_score_local", rows, queries,
                                       ids, metric, meta, matmul)
    offset = int(offset)
    if offset < 0:
        raise ValueError(f"gather_score_local: offset {offset} < 0")
    if rows.device.type == "cpu":
        return gather_score_local_plain(rows, queries, ids, offset,
                                        metric=metric, meta=meta,
                                        matmul=matmul)
    vec = _vec("gather_score_local", rows)
    out = torch.empty((b, k), dtype=torch.float32, device=rows.device)
    with _on(rows):
        err = _lib().gather_score_local_launch(
            rows.data_ptr(), _ROW_TYPE[rows.dtype],
            meta.data_ptr() if meta is not None else None,
            meta.shape[1] if meta is not None else 0, int(matmul),
            queries.data_ptr(), ids.data_ptr(), out.data_ptr(), b, k,
            rows.shape[0], offset, dim, _METRIC_CODE[metric], vec,
            _stream(rows))
    _raise_on("gather_score_local", err)
    launches["gather_score_local"] += 1
    return out


# --------------------------------------------------------------------------
# stable pool merge
# --------------------------------------------------------------------------
def _merge(pool_ids, pool_dists, flags, cand_ids, cand_dists):
    """Dispatch: the kernel on CUDA, the plain version (the stable oracle of
    ``ref``) on CPU. Both sort an f32 copy of the distances and hand them back
    in the inputs' promoted dtype (exact for bf16/f16).

    Temporaries handed to the kernel (the f32 copies) may return to
    PyTorch's caching allocator when this function returns: the allocator
    reuses memory in stream order, and the kernel runs on the current stream.
    """
    dtype = torch.promote_types(pool_dists.dtype, cand_dists.dtype)
    b, p = pool_ids.shape
    k = cand_ids.shape[1]
    if pool_dists.shape != (b, p) or cand_dists.shape != (b, k) or (
            cand_ids.shape[0] != b):
        raise ValueError("beam_merge_topk: pool/candidate shapes disagree")
    if pool_ids.dtype != torch.int32 or cand_ids.dtype != torch.int32:
        raise ValueError("beam_merge_topk: ids must be int32")
    n_pad = 1 << max(p + k - 1, 0).bit_length()
    # the kernel's keys: the full network, or the pool beside the
    # candidates padded to a power of two, whichever is more
    lanes = max(n_pad, p + (1 << max(k - 1, 0).bit_length()))
    if lanes > MAX_MERGE_PAD:
        raise ValueError(f"beam_merge_topk: {lanes} merge lanes exceed "
                         f"the shared-memory limit ({MAX_MERGE_PAD})")
    # the host's work per call is most of the call's time at the engine's
    # shapes: no conversion, copy or allocation that is not needed
    pd = _f32(pool_dists)
    cd = _f32(cand_dists)
    if flags is not None:
        if flags.dtype != torch.bool or flags.shape != (b, p):
            raise ValueError("beam_merge_topk: flags must be (B, P) bool")
        flags = flags.contiguous()
    _check_layout("beam_merge_topk", pool_ids, pd, cand_ids, cd,
                  *([flags] if flags is not None else []))
    if pool_ids.device.type == "cpu":
        if flags is None:
            oi, od = ref.beam_merge_topk_ref(pool_ids, pd, cand_ids, cd)
            return oi, od.to(dtype), None
        oi, od, of = ref.merge_pool_batch_ref(pool_ids, pd, flags, cand_ids,
                                              cd)
        return oi, od.to(dtype), of
    if pool_ids.device.type != "cuda":
        raise ValueError(f"beam_merge_topk: unsupported device {pool_ids.device}")
    oi = torch.empty_like(pool_ids)
    od = torch.empty_like(pd)
    of = None if flags is None else torch.empty_like(flags)
    with _on(pool_ids):
        err = _lib().beam_merge_launch(
            pool_ids.data_ptr(), pd.data_ptr(),
            flags.data_ptr() if flags is not None else None,
            cand_ids.data_ptr(), cd.data_ptr(), oi.data_ptr(), od.data_ptr(),
            of.data_ptr() if of is not None else None, b, p, k, n_pad,
            _stream(pool_ids))
    _raise_on("beam_merge_topk", err)
    launches["beam_merge_topk"] += 1
    return oi, (od if dtype == torch.float32 else od.to(dtype)), of


def beam_merge_topk(beam_ids, beam_dists, cand_ids, cand_dists):
    """Merge (B, L) beam and (B, K) candidates -> stable best-(B, L)."""
    oi, od, _ = _merge(beam_ids, beam_dists, None, cand_ids, cand_dists)
    return oi, od


def merge_pool_batch(pool_ids, pool_dists, expanded, cand_ids, cand_dists):
    """Stable (pool ‖ fanout) merge with the ``expanded`` payload.

    (B, P) pool + (B, K) candidates -> (B, P) ids, dists, expanded; new
    candidates enter unexpanded. Equals ``ref.merge_pool_batch_ref``.
    """
    return _merge(pool_ids, pool_dists, expanded, cand_ids, cand_dists)
