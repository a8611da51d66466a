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
from repro_torch.distributed.sharding import P, search_mesh
from repro_torch.core.vamana import VamanaConfig, VamanaIndex
from repro_torch.kernels.backend import CorpusView, resolve_device
from repro_torch.models import gnn
from repro_torch.models import recsys as R
from repro_torch.models.transformer import (KVCache, Transformer,
                                            TransformerConfig)
from repro_torch.train.optimizer import AdamWState

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


def _flatten(tree: dict | list, prefix: str = "") -> dict:
    """``{dotted path: leaf}`` of a pytree of dicts and lists (a list's
    items under their index)."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for key, val in items:
        if isinstance(val, (dict, list)):
            out.update(_flatten(val, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = val
    return out


def _named(tensors: nn.Module | Mapping[str, torch.Tensor]) -> dict:
    return (dict(tensors.named_parameters()) if isinstance(tensors, nn.Module)
            else dict(tensors))


def _put(tree: dict, path: str, leaf) -> None:
    """Set ``leaf`` at dotted ``path`` in the nested dict ``tree``."""
    *heads, last = path.split(".")
    for key in heads:
        tree = tree.setdefault(key, {})
    tree[last] = leaf


def _copy_into(model: nn.Module, flat: dict, what: str) -> nn.Module:
    """Copy ``flat`` ({parameter name: numpy array}) into ``model``'s
    parameters bit for bit; names, shapes and dtypes must match exactly."""
    want = dict(model.named_parameters())
    if flat.keys() != want.keys():
        raise ValueError(
            f"{what}: parameters {sorted(flat.keys() ^ want.keys())} are in "
            "only one of the pytree and the model")
    dev = next(iter(want.values())).device
    with torch.no_grad():
        for name, arr in flat.items():
            t = tensor_from_numpy(arr, dev)
            if t.shape != want[name].shape or t.dtype != want[name].dtype:
                raise ValueError(
                    f"{what}: {name} is {tuple(t.shape)} {t.dtype}, the "
                    f"model's {tuple(want[name].shape)} {want[name].dtype}")
            want[name].copy_(t)
    return model


def transformer_from_numpy(params: dict, cfg: TransformerConfig,
                           device=None) -> Transformer:
    """A :class:`Transformer` on ``device`` holding a JAX parameter pytree
    (``transformer.init_params``' layout, leaves as numpy arrays): the
    leading L axis of ``dense_blocks`` is unstacked into blocks 0, 1, ...
    and that of ``moe_blocks`` into the blocks after them (``blocks.
    <first_dense + i>``); ``mtp`` is a subtree as it is. Every array is
    copied bit for bit (bf16 included). Names, shapes and dtypes must match
    the model's exactly."""
    dev = resolve_device(device)
    model = Transformer(cfg, dev)
    stacks = {"dense_blocks": 0, "moe_blocks": cfg.n_dense}
    flat = _flatten({k: v for k, v in params.items() if k not in stacks})
    for stack, first in stacks.items():
        for name, arr in _flatten(params.get(stack, {})).items():
            for i in range(np.shape(arr)[0]):
                flat[f"blocks.{first + i}.{name}"] = np.asarray(arr)[i]
    return _copy_into(model, flat, f"transformer_from_numpy: {cfg.name}")


def transformer_to_numpy(tensors: nn.Module | Mapping[str, torch.Tensor]
                         ) -> dict:
    """JAX's parameter pytree (``transformer.init_params``' layout, leaves
    as numpy arrays) from a :class:`Transformer`'s parameters, or from a
    mapping of its parameter names to tensors (their gradients, say): the
    inverse of :func:`transformer_from_numpy`. ``blocks.<i>.<name>`` rows are
    stacked in layer order on a leading L axis: under ``moe_blocks`` for the
    blocks that hold a ``moe`` (the last ones), under ``dense_blocks`` for
    the rest."""
    out: dict = {}
    layers: dict[int, dict[str, np.ndarray]] = {}
    for name, t in _named(tensors).items():
        if name.startswith("blocks."):
            _, i, rest = name.split(".", 2)
            layers.setdefault(int(i), {})[rest] = tensor_to_numpy(t)
        else:
            _put(out, name, tensor_to_numpy(t))
    for stack, moe in (("dense_blocks", False), ("moe_blocks", True)):
        rows = [layers[i] for i in sorted(layers)
                if any(n.startswith("moe.") for n in layers[i]) == moe]
        for rest in (rows[0] if rows else ()):
            _put(out, f"{stack}.{rest}", np.stack([r[rest] for r in rows]))
    return out


_RECSYS = {R.BSTConfig: R.BST, R.DINConfig: R.DIN,
           R.Bert4RecConfig: R.Bert4Rec, R.XDeepFMConfig: R.XDeepFM}


def recsys_from_numpy(params: dict, cfg, device=None) -> nn.Module:
    """The recommender model of ``cfg`` (a ``BSTConfig``, ``DINConfig``,
    ``Bert4RecConfig`` or ``XDeepFMConfig``) on ``device``, holding a JAX
    parameter pytree (``recsys.*_init``'s nested dicts and lists, leaves as
    numpy arrays) bit for bit. Names, shapes and dtypes must match the
    model's exactly."""
    model = _RECSYS[type(cfg)](cfg, resolve_device(device))
    return _copy_into(model, _flatten(params),
                      f"recsys_from_numpy: {cfg.name}")


def recsys_to_numpy(tensors: nn.Module | Mapping[str, torch.Tensor]) -> dict:
    """JAX's parameter pytree (leaves as numpy arrays) from a recommender
    model, or from a mapping of its parameter names to tensors (their
    gradients, say): the inverse of :func:`recsys_from_numpy`. A path part
    that is an index (``blocks.0``, ``ws.2``, ``cin.1``) is a list item."""
    return _pytree(tensors)


def _pytree(tensors: nn.Module | Mapping[str, torch.Tensor]) -> dict:
    """Nested dicts of numpy leaves by the dotted names of ``tensors``; a
    node whose keys are all indices becomes a list."""
    out: dict = {}
    for name, t in _named(tensors).items():
        _put(out, name, tensor_to_numpy(t))

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[k]) for k in sorted(node, key=int)]
        return {k: lists(v) for k, v in node.items()}

    return lists(out)


def gat_from_numpy(params: dict, cfg: gnn.GATConfig,
                   device=None) -> gnn.GAT:
    """A :class:`~repro_torch.models.gnn.GAT` of ``cfg`` on ``device``
    holding JAX's ``{"layers": [{"w", "a_src", "a_dst", "bias"}, ...]}``
    (numpy leaves) bit for bit."""
    model = gnn.GAT(cfg, resolve_device(device))
    return _copy_into(model, _flatten(params), f"gat_from_numpy: {cfg.name}")


def gat_to_numpy(tensors: nn.Module | Mapping[str, torch.Tensor]) -> dict:
    """JAX's GAT pytree from a model, or from a mapping of its parameter
    names to tensors (their gradients): the inverse of
    :func:`gat_from_numpy`."""
    return _pytree(tensors)


def kv_cache_from_numpy(k, v, length, device=None) -> KVCache:
    """A :class:`KVCache` from JAX's (its k and v, as numpy arrays: (L, B, S,
    Hkv, dh) each for GQA, the latents (L, B, S, rank) and RoPE keys (L, B,
    S, rope) for MLA; and its 0-d length), bit for bit on ``device``."""
    dev = resolve_device(device)
    return KVCache(k=tensor_from_numpy(k, dev), v=tensor_from_numpy(v, dev),
                   length=torch.tensor(int(np.asarray(length)),
                                       dtype=torch.int32, device=dev))


def kv_cache_to_numpy(cache: KVCache) -> tuple:
    """(k, v, length) of a :class:`KVCache` as numpy arrays, JAX's
    ``KVCache`` fields (length a 0-d int32)."""
    return (tensor_to_numpy(cache.k), tensor_to_numpy(cache.v),
            np.asarray(tensor_to_numpy(cache.length), np.int32))


def _is_moment(node) -> bool:
    return isinstance(node, dict) and set(node) == {"q", "scale"}


def _spec_leaves(tree, prefix: str = "") -> dict:
    """:func:`_flatten` of a spec pytree: a quantized moment's ``{"q",
    "scale"}`` pair stays one leaf."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for key, val in items:
        if isinstance(val, (dict, list)) and not _is_moment(val):
            out.update(_spec_leaves(val, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = val
    return out


def _port_spec(leaf, stacked: bool):
    if _is_moment(leaf):
        return {k: _port_spec(v, stacked) for k, v in leaf.items()}
    parts = tuple(leaf)
    if stacked:
        if parts[:1] != (None,):
            raise ValueError(f"a stacked layer's spec {leaf} splits the "
                             "layer axis")
        parts = parts[1:]
    return P(*parts)


def specs_from_jax(spec_tree, cfg: TransformerConfig | None = None):
    """JAX's spec pytree (``lm_param_specs``, ``opt_state_specs``, or any
    tree of PartitionSpecs over a parameter pytree) under the port's
    parameter names, each spec a port :class:`~repro_torch.distributed.
    sharding.P`. An LM's ``dense_blocks`` / ``moe_blocks`` are stacked on a
    leading layer axis: their specs lose that axis and go to ``blocks.<i>``
    for each layer, as :func:`transformer_from_numpy` names them (``cfg``
    gives the layer counts). An ``AdamWState`` or a ``KVCache`` comes back
    as the port's, a lone spec as a port ``P``."""
    if hasattr(spec_tree, "_fields"):  # AdamWState, KVCache
        fields = [specs_from_jax(v, cfg) for v in spec_tree]
        if spec_tree._fields == AdamWState._fields:
            return AdamWState(*fields)
        if spec_tree._fields == KVCache._fields:
            return KVCache(*fields)
        return dict(zip(spec_tree._fields, fields))
    if not isinstance(spec_tree, dict):
        return _port_spec(spec_tree, False)
    stacks = ("dense_blocks", "moe_blocks")
    out = {n: _port_spec(v, False) for n, v in _spec_leaves(
        {k: v for k, v in spec_tree.items() if k not in stacks}).items()}
    if not any(k in spec_tree for k in stacks):
        return out
    if cfg is None:
        raise ValueError("specs_from_jax: a stacked LM tree needs its cfg")
    for stack, first, count in (
            ("dense_blocks", 0, cfg.n_dense),
            ("moe_blocks", cfg.n_dense, cfg.n_layers - cfg.n_dense)):
        for name, leaf in _spec_leaves(spec_tree.get(stack, {})).items():
            for i in range(first, first + count):
                out[f"blocks.{i}.{name}"] = _port_spec(leaf, True)
    return out
