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

Both compute the Pallas kernels' function, which differs from the oracles
``ref.flash_attention_ref`` / ``ref.flash_decode_ref`` only on a row with no
valid key: masked scores are the finite ``NEG_INF`` and the output is
``acc / max(l, 1e-30)``, so such a row is 0 where the oracle is NaN. Decode
lengths are clamped to [0, S], as the oracle reads them.

Dispatch is by device only: a CUDA tensor launches the kernel (or raises),
a CPU tensor runs the plain version. Each launch adds one to
:data:`launches`.
"""
from __future__ import annotations

import ctypes
import math

import torch

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
            "flash_decode": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _lib():
    from repro_torch.kernels import _build

    lib = _build.load("flash_attention")
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attention_simt_launch.argtypes = [p, p, p, p, i, i, i, i, i,
                                                    i, f, i, p]
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
        lib.flash_attention_wgmma_launch.argtypes = [p, p, p, p, i, i, i, i, i,
                                                     i, f, i, p]
        lib.flash_attention_wgmma_launch.restype = i
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


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          sm_scale: float | None = None) -> torch.Tensor:
    """The plain PyTorch version of :func:`flash_attention`."""
    sq, dh = q.shape[2], q.shape[3]
    skv = k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    s *= _scale(sm_scale, dh)
    pos = torch.arange(skv, device=q.device)[None, :]
    valid = (pos <= torch.arange(sq, device=q.device)[:, None] + (skv - sq)
             if causal else torch.ones((sq, skv), dtype=torch.bool,
                                       device=q.device))
    p, l = _weights(s, valid)
    return (torch.matmul(p, v.float()) / l).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    sm_scale: float | None = None) -> torch.Tensor:
    """q (B, H, Sq, dh); k (B, H, Skv, dh); v (B, H, Skv, dv) ->
    (B, H, Sq, dv) in q's dtype.

    Key j is valid for query i iff, when ``causal``, j <= i + Skv - Sq.
    ``sm_scale`` defaults to 1/sqrt(dh). q, k, v share one dtype (f32, bf16
    or f16); accumulation is f32.
    """
    b, h, sq, dh = q.shape
    skv, dv = k.shape[2], v.shape[3]
    if k.shape != (b, h, skv, dh) or v.shape[:3] != (b, h, skv):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    _check("flash_attention", q, k, v, dh, dv)
    scale = _scale(sm_scale, dh)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, sm_scale=scale)
    _refuse_grad("flash_attention", q, k, v)
    out = torch.empty((b, h, sq, dv), dtype=q.dtype, device=q.device)
    route = _attention_route(q.dtype, dh, dv)
    with _on(q):
        stream = _stream(q)
        if route == "wgmma":
            if any(t.data_ptr() % 16 for t in (q, k, v, out)):
                raise ValueError("flash_attention: the tensor-core route needs "
                                 "16-byte aligned q, k, v")
            err = _wgmma_lib().flash_attention_wgmma_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                _DTYPE[q.dtype], b * h, sq, skv, dh, dv, scale, int(causal),
                stream)
        else:
            err = _lib().flash_attention_simt_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                _DTYPE[q.dtype], b * h, sq, skv, dh, dv, scale, int(causal),
                stream)
    _raise_on("flash_attention", err)
    launches[f"flash_attention_{route}"] += 1
    return out


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
