"""Carry index, corpus and model state built elsewhere (as numpy arrays) into
the port, and the port's parameters and gradients back out as numpy.

The JAX package and the port draw different random bits, so tests that run
both on one state build it once, hand it across as numpy arrays and wrap it
here. Half-precision and fp8 arrays from ``ml_dtypes`` are reinterpreted
bit for bit.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from repro_torch.core.covertree import FlatCoverTree
from repro_torch.core.distributed import ShardedIndex
from repro_torch.distributed.sharding import search_mesh
from repro_torch.core.vamana import VamanaConfig, VamanaIndex
from repro_torch.kernels.backend import CorpusView, resolve_device
from repro_torch.models.transformer import Transformer, TransformerConfig

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


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """``t``'s values as a host numpy array (bit-exact; bf16 and fp8 as
    ``ml_dtypes`` arrays, the JAX package's types)."""
    t = t.detach().cpu().contiguous()
    for name, (raw, dt) in _BY_NAME.items():
        if t.dtype == dt:
            import ml_dtypes

            bits = torch.int16 if raw == np.uint16 else torch.uint8
            return t.view(bits).numpy().view(raw).view(getattr(ml_dtypes,
                                                                name))
    return t.numpy()


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


def sharded_index_from_numpy(adjacency, medoid, emb_cheap, emb_expensive,
                             config, *, mesh=None,
                             device=None) -> ShardedIndex:
    """A :class:`ShardedIndex` from a stacked one's fields as numpy arrays
    (adjacency (S, n_local, R), medoid (S,), emb_cheap / emb_expensive
    (S, n_local, dim)) and a config. Shard s goes to ``mesh.devices[s]``
    (without a mesh, every shard to ``device``); shards that share one
    device are views of one tensor there."""
    if not isinstance(config, VamanaConfig):
        config = VamanaConfig(**config._asdict())
    n_shards = len(medoid)
    if mesh is None:
        mesh = search_mesh(n_shards,
                           devices=[resolve_device(device)] * n_shards)

    def shards(a):
        if len(set(mesh.devices)) == 1:
            return tuple(tensor_from_numpy(a, mesh.devices[0]).unbind(0))
        return tuple(tensor_from_numpy(a[s], dev)
                     for s, dev in enumerate(mesh.devices))

    return ShardedIndex(
        adjacency=shards(np.asarray(adjacency, np.int32)),
        medoid=tuple(int(m) for m in np.asarray(medoid)),
        emb_cheap=shards(emb_cheap), emb_expensive=shards(emb_expensive),
        config=config)


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flatten(val, f"{prefix}{key}."))
        else:
            out[prefix + key] = val
    return out


def transformer_from_numpy(params: dict, cfg: TransformerConfig,
                           device=None) -> Transformer:
    """A :class:`Transformer` on ``device`` holding a JAX parameter pytree
    (``transformer.init_params``' layout, leaves as numpy arrays): the
    leading L axis of ``dense_blocks`` is unstacked into the per-layer
    blocks, and every array is copied bit for bit (bf16 included). Names,
    shapes and dtypes must match the model's exactly."""
    dev = resolve_device(device)
    model = Transformer(cfg, dev)
    flat = _flatten({k: v for k, v in params.items() if k != "dense_blocks"})
    for name, arr in _flatten(params.get("dense_blocks", {})).items():
        for i in range(np.shape(arr)[0]):
            flat[f"blocks.{i}.{name}"] = np.asarray(arr)[i]
    want = dict(model.named_parameters())
    if flat.keys() != want.keys():
        raise ValueError(
            f"transformer_from_numpy: {cfg.name}: parameters "
            f"{sorted(flat.keys() ^ want.keys())} are in only one of the "
            "pytree and the model")
    with torch.no_grad():
        for name, arr in flat.items():
            t = tensor_from_numpy(arr, dev)
            if t.shape != want[name].shape or t.dtype != want[name].dtype:
                raise ValueError(
                    f"transformer_from_numpy: {name} is {tuple(t.shape)} "
                    f"{t.dtype}, the model's {tuple(want[name].shape)} "
                    f"{want[name].dtype}")
            want[name].copy_(t)
    return model


def transformer_to_numpy(tensors: nn.Module | Mapping[str, torch.Tensor]
                         ) -> dict:
    """JAX's parameter pytree (``transformer.init_params``' layout, leaves
    as numpy arrays) from a :class:`Transformer`'s parameters, or from a
    mapping of its parameter names to tensors (their gradients, say): the
    inverse of :func:`transformer_from_numpy`. ``blocks.<i>.<name>`` rows are
    stacked in layer order on a leading L axis under ``dense_blocks``."""
    named = (dict(tensors.named_parameters()) if isinstance(tensors, nn.Module)
             else dict(tensors))
    out: dict = {}
    layers: dict[str, dict[int, np.ndarray]] = {}

    def put(path: str, arr) -> None:
        *heads, leaf = path.split(".")
        node = out
        for key in heads:
            node = node.setdefault(key, {})
        node[leaf] = arr

    for name, t in named.items():
        if name.startswith("blocks."):
            _, i, rest = name.split(".", 2)
            layers.setdefault(rest, {})[int(i)] = tensor_to_numpy(t)
        else:
            put(name, tensor_to_numpy(t))
    for rest, per_layer in layers.items():
        put(f"dense_blocks.{rest}",
            np.stack([per_layer[i] for i in sorted(per_layer)]))
    return out
