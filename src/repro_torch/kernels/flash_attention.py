"""Attention forward (prefill) and single-token decode kernels.

Hand-written Hopper kernels (CUDA C++ for ``sm_90a``), each with its plain
PyTorch version beside it:

* :func:`flash_attention` replaces the Pallas ``repro.kernels.
  flash_attention.flash_attention``: tiled online-softmax attention, causal
  or not, with the queries at the end of the KV window (bottom-right causal
  alignment) and dv ≠ dh allowed. Bound by operations (2·(dh+dv) per valid
  query-key pair). Two routes, chosen by :func:`_attention_route` from the
  dtype and head dims alone:

  - ``"wgmma"`` (``csrc/flash_attention_wgmma.cu``), bf16/f16 with dh and
    dv multiples of 8: both products on the tensor cores (``wgmma``), f32
    accumulation, 128-query tiles taken most work first (the last tile
    first when causal);
  - ``"simt"`` (``csrc/flash_attention.cu``), f32 and every other 16-bit
    shape: register-blocked f32 SIMT arithmetic.
* :func:`flash_decode` replaces the Pallas ``flash_decode``: one query token
  per (batch, head) against a KV cache with a valid length per batch row.
  Bound by the bytes of the valid K/V prefix. Split-KV: each block takes a
  chunk of one row's keys (:func:`decode_split`), 16-byte loads with four
  keys in flight per lane group, and writes its partial softmax state; a
  second kernel combines a row's partials.
* :func:`flash_attention_bwd` is the gradient of :func:`flash_attention`
  (f32 accumulation, no float atomics, so two calls are bit-equal). It
  replaces no Pallas kernel: JAX differentiates its jnp scan
  (``repro.models.layers.blockwise_attention``) with ``jax.grad``. On a CUDA
  tensor that requires grad, :func:`flash_attention` records the forward
  kernel in a ``torch.autograd.Function``; the forward then also writes
  each query's log-sum-exp (:func:`flash_attention_lse`), and the backward
  reads it instead of recomputing it. A prologue (``csrc/
  flash_attention_bwd.cu``) forms Delta = rowsum(dO o O), then one of three
  routes, chosen by :func:`_backward_route` from the dtype and head dims
  alone, runs a dK/dV pass over key tiles and a dQ pass over query tiles:

  - ``"wgmma"`` (``csrc/flash_attention_bwd_wgmma.cu``), bf16/f16 with dh
    and dv multiples of 8 up to 128: every product on the tensor cores
    (``wgmma``, TMA copies, P and dS rounded to the inputs' type);
  - ``"tf32"`` (``csrc/flash_attention_bwd.cu``), f32 with the same widths:
    every product on the tensor cores as 3xTF32 (``mma.sync``, each operand
    split into a TF32 high part and its remainder, three products), operands
    double-buffered through ``cp.async``;
  - ``"simt"`` (``csrc/flash_attention_bwd.cu``), every other shape
    (heads above 128, widths not multiples of 8): f32 SIMT arithmetic.

Both compute the Pallas kernels' function, which differs from the oracles
``ref.flash_attention_ref`` / ``ref.flash_decode_ref`` only on a row with no
valid key: masked scores are the finite ``NEG_INF`` and the output is
``acc / max(l, 1e-30)``, so such a row is 0 where the oracle is NaN. Decode
lengths are clamped to [0, S], as the oracle reads them.

Dispatch is by device only: a CUDA tensor launches the kernel (or raises),
a CPU tensor runs the plain version (which autograd differentiates). Each
launch adds one to :data:`launches`.
"""
from __future__ import annotations

import ctypes
import math

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels.l2_topk import (_check_layout, _on, _raise_on,
                                         _refuse_grad, _stream)

#: the Pallas kernels' mask value: finite, so exp(m_prev - m_new) is never NaN
NEG_INF = -1e30
#: widest head (dh and dv) the kernels take
MAX_HEAD_DIM = 256
_DTYPE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

#: kernel launches since the last :func:`reset_launches`, by kernel name;
#: each route of :func:`flash_attention` counts under its own
launches = {"flash_attention_wgmma": 0, "flash_attention_simt": 0,
            "flash_attention_bwd": 0, "flash_attention_bwd_wgmma": 0,
            "flash_attention_bwd_tf32": 0, "flash_attention_bwd_simt": 0,
            "flash_decode": 0}
#: the backward's routes, as :func:`_backward_route` names them; each call
#: counts under ``flash_attention_bwd`` and under its route's key
BWD_ROUTES = ("wgmma", "tf32", "simt")


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _lib():
    from repro_torch.kernels import _build

    lib = _build.load("flash_attention")
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attention_simt_launch.argtypes = [p, p, p, p, p, i, i, i, i,
                                                    i, i, f, i, p]
        lib.flash_attention_simt_launch.restype = i
        lib.flash_decode_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i,
                                            i, i, i, f, p]
        lib.flash_decode_launch.restype = i
        lib._typed = True
    return lib


def _wgmma_lib():
    from repro_torch.kernels import _build

    lib = _build.load("flash_attention_wgmma")
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attention_wgmma_launch.argtypes = [p, p, p, p, p, i, i, i, i,
                                                     i, i, f, i, p]
        lib.flash_attention_wgmma_launch.restype = i
        lib._typed = True
    return lib


def _bwd_lib():
    from repro_torch.kernels import _build

    lib = _build.load("flash_attention_bwd")
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attention_bwd_prologue.argtypes = ([p] * 6 + [i] * 7
                                                     + [f, i, p])
        lib.flash_attention_bwd_prologue.restype = i
        lib.flash_attention_bwd_launch.argtypes = ([p] * 9 + [i] * 6
                                                   + [f, i, i, p])
        lib.flash_attention_bwd_launch.restype = i
        lib._typed = True
    return lib


def _bwd_wgmma_lib():
    from repro_torch.kernels import _build

    lib = _build.load("flash_attention_bwd_wgmma")
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attention_bwd_wgmma_launch.argtypes = ([p] * 9 + [i] * 6
                                                         + [f, i, p])
        lib.flash_attention_bwd_wgmma_launch.restype = i
        lib._typed = True
    return lib


def _scale(sm_scale, dh: int) -> float:
    return float(sm_scale) if sm_scale is not None else 1.0 / math.sqrt(dh)


def _check(name: str, q, k, v, dh: int, dv: int) -> None:
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE:
        raise ValueError(f"{name}: q, k, v must share one of {list(_DTYPE)}, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    _check_layout(name, q, k, v)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {q.device}")
    if q.device.type == "cuda" and max(dh, dv) > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dims {dh}/{dv} > {MAX_HEAD_DIM}")


def _weights(s: torch.Tensor, valid: torch.Tensor):
    """The Pallas kernels' softmax over the last axis of f32 scores ``s``:
    (unnormalised weights, max(l, 1e-30)). Masked scores are ``NEG_INF``,
    so a row with no valid key has weights 0, not NaN. Out of place, so
    that autograd can differentiate the plain versions."""
    s = s.masked_fill(~valid, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True)).masked_fill(~valid, 0.0)
    return p, p.sum(-1, keepdim=True).clamp(min=1e-30)


# --------------------------------------------------------------------------
# attention forward
# --------------------------------------------------------------------------
def _attention_route(dtype: torch.dtype, dh: int, dv: int) -> str:
    """Which kernel runs a CUDA call: ``"wgmma"`` (tensor cores) for bf16 or
    f16 with dh and dv multiples of 8 in [8, 256] (a row of 16-bit elements
    is then a multiple of 16 bytes, the copy engine's stride rule), else
    ``"simt"``."""
    if dtype in (torch.bfloat16, torch.float16) and all(
            0 < d <= MAX_HEAD_DIM and d % 8 == 0 for d in (dh, dv)):
        return "wgmma"
    return "simt"


def _backward_route(dtype: torch.dtype, dh: int, dv: int) -> str:
    """Which backward kernel runs a CUDA call, from the dtype and head dims
    alone: with dh and dv multiples of 8 in [8, 128], ``"wgmma"`` for bf16
    and f16 and ``"tf32"`` (3xTF32 tensor-core products) for f32; every other
    shape ``"simt"``."""
    if all(0 < d <= 128 and d % 8 == 0 for d in (dh, dv)):
        if dtype in (torch.bfloat16, torch.float16):
            return "wgmma"
        if dtype == torch.float32:
            return "tf32"
    return "simt"


def _valid(sq: int, skv: int, causal: bool, device) -> torch.Tensor:
    """(Sq, Skv) bool: key j is valid for query i (bottom-right causal)."""
    if not causal:
        return torch.ones((sq, skv), dtype=torch.bool, device=device)
    pos = torch.arange(skv, device=device)[None, :]
    return pos <= torch.arange(sq, device=device)[:, None] + (skv - sq)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          sm_scale: float | None = None) -> torch.Tensor:
    """The plain PyTorch version of :func:`flash_attention`."""
    return flash_attention_lse_plain(q, k, v, causal=causal,
                                     sm_scale=sm_scale)[0]


def flash_attention_lse_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              sm_scale: float | None = None):
    """The plain PyTorch version of :func:`flash_attention_lse`: (out, lse),
    lse (B, H, Sq) f32 = m + log(max(l, 1e-30)) of the scaled scores over
    the valid keys (``NEG_INF`` for a row with none)."""
    sq, dh = q.shape[2], q.shape[3]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    s *= _scale(sm_scale, dh)
    valid = _valid(sq, k.shape[2], causal, q.device)
    p, l = _weights(s, valid)
    m = s.masked_fill(~valid, NEG_INF).amax(-1, keepdim=True)
    out = (torch.matmul(p, v.float()) / l).to(q.dtype)
    return out, (m + torch.log(l)).squeeze(-1)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, out: torch.Tensor,
                              dout: torch.Tensor, *, causal: bool = True,
                              sm_scale: float | None = None):
    """The plain PyTorch version of :func:`flash_attention_bwd`: P
    recomputed in f32, ``dV = P^T dO``, ``dP = dO V^T``, ``dS = P o (dP -
    rowsum(dO o O))``, ``dQ = dS K scale``, ``dK = dS^T Q scale``; each
    gradient in its input's dtype. ``out`` is the forward's output, as the
    kernel reads it."""
    sq, dh = q.shape[2], q.shape[3]
    scale = _scale(sm_scale, dh)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), dout.float()
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    p, l = _weights(s, _valid(sq, k.shape[2], causal, q.device))
    p = p / l
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = p * (dp - (dof * out.float()).sum(-1, keepdim=True))
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_shapes(name: str, q, k, v):
    b, h, sq, dh = q.shape
    skv, dv = k.shape[2], v.shape[3]
    if k.shape != (b, h, skv, dh) or v.shape[:3] != (b, h, skv):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    _check(name, q, k, v, dh, dv)
    return b, h, sq, skv, dh, dv


def _forward_card(q, k, v, causal: bool, scale: float,
                  lse: torch.Tensor | None = None) -> torch.Tensor:
    """The forward kernel on CUDA tensors checked by the caller; with
    ``lse`` ((B, H, Sq) f32) it also writes each row's log-sum-exp."""
    b, h, sq, dh = q.shape
    skv, dv = k.shape[2], v.shape[3]
    out = torch.empty((b, h, sq, dv), dtype=q.dtype, device=q.device)
    route = _attention_route(q.dtype, dh, dv)
    lse_p = None if lse is None else lse.data_ptr()
    with _on(q):
        stream = _stream(q)
        if route == "wgmma":
            if any(t.data_ptr() % 16 for t in (q, k, v, out)):
                raise ValueError("flash_attention: the tensor-core route needs "
                                 "16-byte aligned q, k, v")
            err = _wgmma_lib().flash_attention_wgmma_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse_p, _DTYPE[q.dtype], b * h, sq, skv, dh, dv, scale,
                int(causal), stream)
        else:
            err = _lib().flash_attention_simt_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse_p, _DTYPE[q.dtype], b * h, sq, skv, dh, dv, scale,
                int(causal), stream)
    _raise_on("flash_attention", err)
    launches[f"flash_attention_{route}"] += 1
    return out


def _backward_card(q, k, v, out, dout, causal: bool, scale: float,
                   lse: torch.Tensor | None = None, route: str | None = None):
    """The backward on CUDA tensors checked by the caller: (dq, dk, dv), one
    counted launch (the prologue and the route's two passes). ``lse`` is the
    forward's (B, H, Sq) f32 log-sum-exp; without it the prologue
    recomputes it. ``route`` overrides :func:`_backward_route` to time one
    route against another on the same inputs; the kernel refuses a shape
    its route does not take."""
    b, h, sq, dh = q.shape
    skv, dv = k.shape[2], v.shape[3]
    route = route or _backward_route(q.dtype, dh, dv)
    dq, dk, dvt = (torch.empty_like(t) for t in (q, k, v))
    if route != "simt" and any(t.data_ptr() % 16 for t in
                               (q, k, v, dout, dq, dk, dvt)):
        raise ValueError(f"flash_attention_bwd: the {route} route needs "
                         "16-byte aligned q, k, v, dout")
    # Delta = rowsum(dout o out), then (without the forward's) each query's
    # log-sum-exp, in f32
    n = b * h * sq
    work = torch.empty((1 if lse is not None else 2) * n, dtype=torch.float32,
                       device=q.device)
    lse_p = lse.data_ptr() if lse is not None else work.data_ptr() + 4 * n
    delta_p = work.data_ptr()
    dims = (_DTYPE[q.dtype], b * h, sq, skv, dh, dv, scale, int(causal))
    with _on(q):
        stream = _stream(q)
        lib = _bwd_lib()
        err = lib.flash_attention_bwd_prologue(
            q.data_ptr(), k.data_ptr(), out.data_ptr(), dout.data_ptr(), lse_p,
            delta_p, int(lse is not None), *dims, stream)
        if err == 0:
            ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                    dq.data_ptr(), dk.data_ptr(), dvt.data_ptr(), lse_p,
                    delta_p)
            if route == "wgmma":
                err = _bwd_wgmma_lib().flash_attention_bwd_wgmma_launch(
                    *ptrs, *dims, stream)
            else:
                err = lib.flash_attention_bwd_launch(
                    *ptrs, *dims, int(route == "tf32"), stream)
    _raise_on("flash_attention_bwd", err)
    launches["flash_attention_bwd"] += 1
    launches[f"flash_attention_bwd_{route}"] += 1
    return dq, dk, dvt


class _FlashAttention(torch.autograd.Function):
    """The forward kernel, which also writes each row's log-sum-exp,
    differentiated by the backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        b, h, sq = q.shape[:3]
        lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
        out = _forward_card(q, k, v, causal, scale, lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _backward_card(q, k, v, out, dout.contiguous(),
                                    ctx.causal, ctx.scale, lse)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    sm_scale: float | None = None) -> torch.Tensor:
    """q (B, H, Sq, dh); k (B, H, Skv, dh); v (B, H, Skv, dv) ->
    (B, H, Sq, dv) in q's dtype.

    Key j is valid for query i iff, when ``causal``, j <= i + Skv - Sq.
    ``sm_scale`` defaults to 1/sqrt(dh). q, k, v share one dtype (f32, bf16
    or f16); accumulation is f32. Differentiable: on a CUDA tensor that
    requires grad (grad on) the backward is :func:`flash_attention_bwd`'s
    kernel, on a CPU tensor autograd through the plain version.
    """
    _check_shapes("flash_attention", q, k, v)
    scale = _scale(sm_scale, q.shape[3])
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, sm_scale=scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, scale)
    return _forward_card(q, k, v, causal, scale)


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, sm_scale: float | None = None):
    """:func:`flash_attention` that also returns each row's log-sum-exp:
    (out, lse), lse (B, H, Sq) f32 over the valid keys of the scaled scores
    (``NEG_INF`` for a row with none), as the autograd forward saves it for
    the backward. Not differentiable; one counted forward launch."""
    b, h, sq = _check_shapes("flash_attention_lse", q, k, v)[:3]
    scale = _scale(sm_scale, q.shape[3])
    if q.device.type == "cpu":
        return flash_attention_lse_plain(q, k, v, causal=causal,
                                         sm_scale=scale)
    _refuse_grad("flash_attention_lse", q, k, v)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    return _forward_card(q, k, v, causal, scale, lse), lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor, *,
                        causal: bool = True, sm_scale: float | None = None,
                        lse: torch.Tensor | None = None):
    """The gradient of :func:`flash_attention`: q, k, v as there, ``out`` its
    output and ``dout`` the cotangent of ``out`` (both (B, H, Sq, dv), the
    inputs' dtype) -> (dq, dk, dv) in the inputs' dtype. A query with no
    valid key gets a zero dq and adds nothing to dk and dv. ``lse``, the
    forward's (B, H, Sq) f32 log-sum-exp (:func:`flash_attention_lse`),
    spares the kernel recomputing it; the plain version does not read it."""
    b, h, sq, skv, dh, dv = _check_shapes("flash_attention_bwd", q, k, v)
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != (b, h, sq, dv) or t.dtype != q.dtype:
            raise ValueError(f"flash_attention_bwd: {name} is "
                             f"{tuple(t.shape)} {t.dtype}, want "
                             f"{(b, h, sq, dv)} {q.dtype}")
    _check_layout("flash_attention_bwd", q, out, dout)
    if lse is not None and (lse.shape != (b, h, sq)
                            or lse.dtype != torch.float32
                            or lse.device != q.device
                            or not lse.is_contiguous()):
        raise ValueError(f"flash_attention_bwd: lse is {tuple(lse.shape)} "
                         f"{lse.dtype} on {lse.device}, want a contiguous "
                         f"{(b, h, sq)} float32 beside q")
    scale = _scale(sm_scale, dh)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, dout, causal=causal,
                                         sm_scale=scale)
    return _backward_card(q, k, v, out, dout, causal, scale, lse)


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------
#: keys per split-KV block: at most, and at least
DECODE_CHUNK_MAX, DECODE_CHUNK_MIN = 1024, 64
#: blocks a decode launch aims for at least: about one wave of 132 SMs with
#: eight blocks resident on each (a block has ~64 registers a thread). Past
#: that, larger chunks pay a block's start-up fewer times (PERF.md)
DECODE_BLOCKS = 1024
#: most splits per (batch, head): the combine keeps one f32 weight per split
#: in shared memory
DECODE_MAX_SPLITS = 4096


def decode_split(s: int, bh: int) -> tuple[int, int]:
    """(chunk, n_split) of the split-KV decode over S keys and B·H rows.

    The chunk is a power of two, 1024 keys halved down to 64 while the grid
    of ``bh * n_split`` blocks stays under :data:`DECODE_BLOCKS`, then
    doubled while there are more than :data:`DECODE_MAX_SPLITS` splits; the
    splits ``[i * chunk, min((i + 1) * chunk, S))`` cover every key once.
    It depends on the shapes alone: the lengths live on the card, and
    reading them would sync the stream in every decode step.
    """
    chunk = DECODE_CHUNK_MAX
    while chunk > DECODE_CHUNK_MIN and bh * -(-s // chunk) < DECODE_BLOCKS:
        chunk //= 2
    while -(-s // chunk) > DECODE_MAX_SPLITS:
        chunk *= 2
    return chunk, -(-s // chunk)


def _lengths(length, b: int, s: int, device: torch.device) -> torch.Tensor:
    """(B,) int32 valid lengths on ``device`` from an int or a (B,) tensor,
    clamped to [0, S]."""
    if isinstance(length, torch.Tensor) and length.device != device:
        raise ValueError(f"flash_decode: length on {length.device}, q on "
                         f"{device}")
    lens = torch.as_tensor(length, device=device).to(torch.int32).reshape(-1)
    return lens.expand(b).clamp(0, s).contiguous()


def _kernel_lengths(length, b: int, s: int,
                    device: torch.device) -> torch.Tensor:
    """(B,) int32 lengths for the kernels: a contiguous (B,) int32 tensor on
    ``device`` as it is (the kernels clamp), anything else through
    :func:`_lengths`."""
    if (isinstance(length, torch.Tensor) and length.dtype == torch.int32
            and length.shape == (b,) and length.device == device
            and length.is_contiguous()):
        return length
    return _lengths(length, b, s, device)


def flash_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       length, sm_scale: float | None = None) -> torch.Tensor:
    """The plain PyTorch version of :func:`flash_decode`."""
    b, _, dh = q.shape
    s = k.shape[1]
    lens = _lengths(length, b, s, q.device)
    logits = torch.einsum("bhd,bshd->bhs", q.float(), k.float())
    logits *= _scale(sm_scale, dh)
    valid = torch.arange(s, device=q.device)[None, None, :] < lens[:, None,
                                                                    None]
    p, l = _weights(logits, valid)
    return (torch.einsum("bhs,bshd->bhd", p, v.float()) / l).to(q.dtype)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 length, sm_scale: float | None = None) -> torch.Tensor:
    """q (B, H, dh); k (B, S, H, dh); v (B, S, H, dv) -> (B, H, dv) in q's
    dtype: one query token per (batch, head) against a KV cache.

    ``length`` (int or (B,), broadcast over heads) is the valid prefix of
    each batch row's cache, clamped to [0, S]. A CUDA ``length`` tensor
    stays on the card (an int32 (B,) one is read as it is); an int is
    copied there.
    """
    b, h, dh = q.shape
    s, dv = k.shape[1], v.shape[3]
    if k.shape != (b, s, h, dh) or v.shape[:3] != (b, s, h):
        raise ValueError(f"flash_decode: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    _check("flash_decode", q, k, v, dh, dv)
    scale = _scale(sm_scale, dh)
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, length=length, sm_scale=scale)
    _refuse_grad("flash_decode", q, k, v)
    lens = _kernel_lengths(length, b, s, q.device)
    chunk, n_split = decode_split(s, b * h)
    out = torch.empty((b, h, dv), dtype=q.dtype, device=q.device)
    # the splits' partials (m, l, acc[dv]) in f32, from the caching allocator
    work = torch.empty(b * h * n_split * (dv + 2), dtype=torch.float32,
                       device=q.device)
    with _on(q):
        err = _lib().flash_decode_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
            out.data_ptr(), work.data_ptr(), _DTYPE[q.dtype], b, h, s, dh, dv,
            chunk, n_split, scale, _stream(q))
    _raise_on("flash_decode", err)
    launches["flash_decode"] += 1
    return out
