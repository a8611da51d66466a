"""Carry index and corpus state built elsewhere (as numpy arrays) into the port.

The JAX package and the port draw different random bits, so tests that run
both on one state build it once, hand it across as numpy arrays and wrap it
here. Half-precision and fp8 arrays from ``ml_dtypes`` are reinterpreted
bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.covertree import FlatCoverTree
from repro_torch.core.vamana import VamanaConfig, VamanaIndex
from repro_torch.kernels.backend import CorpusView, resolve_device

_BY_NAME = {"bfloat16": (np.uint16, torch.bfloat16),
            "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
            "float8_e5m2": (np.uint8, torch.float8_e5m2)}


def tensor_from_numpy(a, device=None) -> torch.Tensor:
    """A tensor on ``device`` holding ``a``'s values (bit-exact)."""
    dev = resolve_device(device)
    a = np.array(a, copy=True, order="C")  # writable, contiguous
    if a.dtype.name in _BY_NAME:
        raw, dt = _BY_NAME[a.dtype.name]
        return torch.from_numpy(a.view(raw)).view(dt).to(dev)
    return torch.from_numpy(a).to(dev)


def index_from_numpy(adjacency, medoid, config, device=None) -> VamanaIndex:
    """A :class:`VamanaIndex` from an (N, R) adjacency, a medoid id and a
    config (a ``VamanaConfig`` or any NamedTuple with its fields)."""
    if not isinstance(config, VamanaConfig):
        config = VamanaConfig(**config._asdict())
    adj = tensor_from_numpy(np.asarray(adjacency, np.int32), device)
    return VamanaIndex(adjacency=adj, medoid=int(np.asarray(medoid)),
                       config=config)


def corpus_view_from_numpy(rows, sq_norms, inv_norms, scales=None,
                           zero_points=None, device=None) -> CorpusView:
    """A :class:`CorpusView` from its fields as numpy arrays."""
    conv = lambda a: None if a is None else tensor_from_numpy(a, device)
    return CorpusView(rows=conv(rows), sq_norms=conv(sq_norms),
                      inv_norms=conv(inv_norms), scales=conv(scales),
                      zero_points=conv(zero_points))


def flat_cover_tree_from_numpy(children, radii, root_ids, scale, T, n,
                               device=None) -> FlatCoverTree:
    """A :class:`FlatCoverTree` from its fields (a flattened tree's
    ``(depth-1, N, R)`` child table, radii and root ids as numpy arrays);
    the child table goes to ``device``."""
    return FlatCoverTree(
        children=tensor_from_numpy(np.asarray(children, np.int32), device),
        radii=np.array(radii, np.float64), root_ids=np.array(root_ids,
                                                             np.int32),
        scale=float(scale), T=float(T), n=int(n))
