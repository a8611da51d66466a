"""Embedding-bag kernel: the sum or mean of each bag's table rows.

One hand-written Hopper kernel (``csrc/embedding_bag.cu``, CUDA C++ for
``sm_90a``) with its plain PyTorch version beside it. :func:`embedding_bag`
replaces the Pallas ``repro.kernels.embedding_bag.embedding_bag``: per bag,
the table rows gathered by id are summed in f32, ids < 0 are pads that add
0, and the mean divides by max(count, 1). Bound by the bytes of the valid
rows. :func:`bag_plan` picks the kernel's work split from the shapes and the
table's alignment alone: lane groups sized to the row with vector loads,
several rows in flight per warp, and several warps per bag when the bags
alone cannot fill the card.

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
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels.l2_topk import (_check_layout, _on, _raise_on,
                                         _refuse_grad, _stream)

MODES = ("sum", "mean")
_DTYPE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

#: most warps that share one bag (the kernel's block)
BAG_MAX_WARPS = 8
#: ids a warp of a shared bag takes at least: one coalesced load a lane.
#: A warp with fewer would spend its round trips on a handful of rows
BAG_MIN_IDS = 32
#: warps a launch aims for: about half of what 132 SMs hold (64 each), so
#: enough row loads are in flight to cover the card's memory latency
BAG_WARPS = 4096
_INT_MAX = 2**31 - 1

#: kernel launches since the last :func:`reset_launches`, by kernel name
launches = {"embedding_bag": 0}


def reset_launches() -> None:
    launches["embedding_bag"] = 0


_launch_fn = None


def _launch():
    """The typed ``embedding_bag_launch`` of the built library, looked up
    once: the wrapper's host work is most of a small call's time."""
    global _launch_fn
    if _launch_fn is None:
        from repro_torch.kernels import _build

        fn = _build.load("embedding_bag").embedding_bag_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, p, i, i, i, i, i, i, i, i, p]
        fn.restype = i
        _launch_fn = fn
    return _launch_fn


class BagPlan(NamedTuple):
    """The kernel's work split: ``width`` bytes a lane loads at once,
    ``lanes`` lanes read one row (rows wider than 32 loads loop over chunks
    of 32 lanes), ``warps_per_bag`` warps share one bag. One block a bag."""
    width: int
    lanes: int
    warps_per_bag: int


@functools.lru_cache(maxsize=256)
def bag_plan(b: int, l: int, d: int, itemsize: int, align: int) -> BagPlan:
    """The work split of the kernel over B bags of L ids and rows of D
    elements of ``itemsize`` bytes, at a table address divisible by
    ``align``.

    The width is the widest of 16, 8, 4, 2 bytes (at least one element) that
    divides the row stride and ``align``, so no load is misaligned; a warp
    reads ``32 // lanes`` rows per pass. Each bag is one block, of 1 warp,
    or of 2, 4 or 8 while the launch has fewer than :data:`BAG_WARPS` warps
    and each warp still gets :data:`BAG_MIN_IDS` ids. A block of one bag
    frees its SM's slot as soon as that bag is done. Shapes only: the ids
    stay on the card, and reading them would sync the stream on every call.
    Raises for a shape the kernel's 32-bit sizes cannot hold. Cached: a
    model calls it with the same few shapes on every step.
    """
    row = d * itemsize
    if min(b, l) < 0 or d < 1 or max(b, l, row) > _INT_MAX:
        raise ValueError(f"embedding_bag: no plan for B={b}, L={l}, D={d} of "
                         f"{itemsize} bytes")
    width = 16
    while width > itemsize and (row % width or align % width):
        width //= 2
    need = max(1, -(-l // BAG_MIN_IDS))
    warps = 1
    while 2 * warps <= min(need, BAG_MAX_WARPS) and b * warps < BAG_WARPS:
        warps *= 2
    return BagPlan(width, min(row // width, 32), warps)


def table_plan(table: torch.Tensor, idx: torch.Tensor) -> BagPlan:
    """:func:`bag_plan` for these tensors: their shapes and the table's
    address."""
    (b, l), d = idx.shape, table.shape[1]
    # the address modulo 16 has the same divisors up to 16: a few cache keys
    return bag_plan(b, l, d, table.element_size(), table.data_ptr() % 16 or 16)


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
    if idx.dtype != torch.int32:
        idx = idx.to(torch.int32)
    _check_layout("embedding_bag", table, idx)
    if not table.is_cuda:
        if table.device.type == "cpu":
            return embedding_bag_plain(table, idx, mode=mode)
        raise ValueError(f"embedding_bag: unsupported device {table.device}")
    _refuse_grad("embedding_bag", table)
    (v, d), (b, l) = table.shape, idx.shape
    out = table.new_empty((b, d))
    if b == 0 or d == 0:
        return out
    if v > _INT_MAX:
        raise ValueError(f"embedding_bag: V={v} rows past the kernel's 32-bit "
                         "ids")
    ptr = table.data_ptr()
    plan = bag_plan(b, l, d, table.element_size(), ptr % 16 or 16)
    with _on(table):
        err = _launch()(ptr, _DTYPE[table.dtype], idx.data_ptr(),
                        out.data_ptr(), b, l, v, d, *plan, mode == "mean",
                        _stream(table))
    _raise_on("embedding_bag", err)
    launches["embedding_bag"] += 1
    return out
