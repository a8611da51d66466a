"""Embedding-bag kernel: the sum or mean of each bag's table rows.

One hand-written Hopper kernel (``csrc/embedding_bag.cu``, CUDA C++ for
``sm_90a``) with its plain PyTorch version beside it. :func:`embedding_bag`
replaces the Pallas ``repro.kernels.embedding_bag.embedding_bag``: per bag,
the table rows gathered by id are summed in f32, ids < 0 are pads that add
0, and the mean divides by max(count, 1). Bound by the bytes of the valid
rows. One warp per bag, its lanes over the row's columns, several rows in
flight.

The oracle ``ref.embedding_bag_ref`` sums in the table's dtype; the kernel
and its plain version accumulate in f32 and cast once, as the Pallas kernel
does. Ids >= V are a caller error: the plain version raises, the kernel
gives NaN for that bag and reads nothing outside the table.

Dispatch is by device only: a CUDA tensor launches the kernel (or raises),
a CPU tensor runs the plain version. Each launch adds one to
:data:`launches`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.l2_topk import _check_layout, _raise_on

MODES = ("sum", "mean")
_DTYPE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

#: kernel launches since the last :func:`reset_launches`, by kernel name
launches = {"embedding_bag": 0}


def reset_launches() -> None:
    launches["embedding_bag"] = 0


def _lib():
    from repro_torch.kernels import _build

    lib = _build.load("embedding_bag")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.embedding_bag_launch.argtypes = [p, i, p, p, i, i, i, i, i, p]
        lib.embedding_bag_launch.restype = i
        lib._typed = True
    return lib


def embedding_bag_plain(table: torch.Tensor, idx: torch.Tensor, *,
                        mode: str = "sum") -> torch.Tensor:
    """The plain PyTorch version of :func:`embedding_bag`."""
    valid = idx >= 0
    rows = table[idx.clamp(min=0).long()].float()  # (B, L, D)
    out = torch.where(valid[..., None], rows, 0.0).sum(dim=1)
    if mode == "mean":
        out = out / valid.sum(-1, keepdim=True).clamp(min=1)
    return out.to(table.dtype)


def embedding_bag(table: torch.Tensor, idx: torch.Tensor, *,
                  mode: str = "sum") -> torch.Tensor:
    """table (V, D); idx (B, L) integer, < 0 pads -> (B, D) in the table's
    dtype (f32, bf16 or f16), accumulated in f32."""
    if mode not in MODES:
        raise ValueError(f"embedding_bag: mode must be one of {MODES}, got "
                         f"{mode!r}")
    if table.dtype not in _DTYPE:
        raise ValueError(f"embedding_bag: unsupported table dtype {table.dtype}")
    if table.dim() != 2 or idx.dim() != 2 or table.shape[0] == 0:
        raise ValueError(f"embedding_bag: table {tuple(table.shape)} must be "
                         f"(V >= 1, D) and idx {tuple(idx.shape)} (B, L)")
    idx = idx.to(torch.int32)
    _check_layout("embedding_bag", table, idx)
    if table.device.type == "cpu":
        return embedding_bag_plain(table, idx, mode=mode)
    if table.device.type != "cuda":
        raise ValueError(f"embedding_bag: unsupported device {table.device}")
    (v, d), (b, l) = table.shape, idx.shape
    out = torch.empty((b, d), dtype=table.dtype, device=table.device)
    with torch.cuda.device(table.device):
        err = _lib().embedding_bag_launch(
            table.data_ptr(), _DTYPE[table.dtype], idx.data_ptr(),
            out.data_ptr(), b, l, v, d, int(mode == "mean"),
            torch.cuda.current_stream(table.device).cuda_stream)
    _raise_on("embedding_bag", err)
    launches["embedding_bag"] += 1
    return out
