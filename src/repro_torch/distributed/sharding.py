"""Search-corpus placement for the sharded beam engine, and the sharding
rules of training on a (data, model) mesh.

``shard_corpus`` splits the corpus into contiguous equal blocks (zero-padded
when the row count does not divide), ``shard_corpus_view`` does the same for
a whole ``CorpusView`` (rows plus norms and dequant parameters), and
``search_mesh`` names the ordered device of each shard.

Global row i lives on shard ``i // n_local`` at local row ``i % n_local``.
Pad rows sit at global ids >= N, which never appear in an adjacency list, so
they are never gathered, scored or marked.

Training (JAX's ``lm_param_specs`` and its kin): a :class:`P` names the mesh
axes each dimension is split over, a :class:`NamedSharding` pairs it with a
``launch.mesh.Mesh``, and :func:`shard_tensor` cuts a tensor into one block
a mesh position (JAX's ``device_put``), :func:`gather_tensor` puts it back
together (reading a global array). Axis roles:

* ``tp``: the tensor/expert axis ("model");
* ``fsdp``: the parameter-sharding data axes ("data", and "pod" when
  present): every weight of two or more dimensions is split over both tp
  and fsdp (ZeRO-3), the optimizer's state included;
* batch axes: the batch is split over ("pod", "data").

The rules read a parameter's name and shape, so one rule covers the dense
LMs, MLA, MoE (experts over tp when their count divides it), the GAT
(replicated) and the recommenders (tables split by rows).

``activation_mesh`` and the ``constrain*`` family return their input: a
sharding constraint never changes a value, and one controller has no
compiler to hint. The models do not call them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.kernels.backend import (NORM_EPS, CorpusView, as_corpus_view,
                                         resolve_device)
from repro_torch.launch.mesh import Mesh
from repro_torch.train.optimizer import AdamWState, named

SEARCH_AXIS = "shard"  # the JAX package's name for the search mesh's axis


class SearchMesh(NamedTuple):
    """A 1-D mesh: the device of each shard, in shard order.

    The sharded engine keeps its replicated state on ``devices[0]``; shard s
    holds its corpus block and its bitmap columns on ``devices[s]``. One
    device may appear several times: then those shards share it. Every
    device is of one type.
    """

    devices: tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def search_mesh(n_shards: int, devices=None, *, device=None) -> SearchMesh:
    """A 1-D mesh of ``n_shards`` shards.

    ``devices`` lists the device of each shard, e.g. ``["cuda:0"] * 4`` to
    put four shards on one card, or ``["cpu"] * 4`` in tests; they must all
    be of one type, so that no shard runs the plain versions while the
    others launch kernels. Without it the mesh takes the first ``n_shards``
    devices of ``device``'s type (the card unless ``device="cpu"``; the CPU
    counts as one device) and raises when there are fewer.
    """
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if devices is not None:
        devs = tuple(torch.device(d) for d in devices)
        if len(devs) != n_shards:
            raise ValueError(f"search_mesh({n_shards}) got {len(devs)} devices")
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"search_mesh devices mix types: {devs}")
        return SearchMesh(devs)
    dev = resolve_device(device)
    if dev.type == "cuda":
        have = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        have = [dev]
    if len(have) < n_shards:
        one = f"'{dev.type}:0'" if dev.type == "cuda" else f"'{dev.type}'"
        raise ValueError(
            f"shards={n_shards} needs {n_shards} devices, have {len(have)} "
            f"(put several shards on one device with search_mesh({n_shards}, "
            f"devices=[{one}] * {n_shards}))")
    return SearchMesh(tuple(have[:n_shards]))


def shard_corpus(corpus: torch.Tensor, n_shards: int):
    """(N, dim) -> ((S, n_local, dim), n_local), zero rows padding the end."""
    n, dim = corpus.shape
    n_local = math.ceil(n / n_shards)
    pad = n_shards * n_local - n
    if pad:
        corpus = torch.cat([corpus, corpus.new_zeros((pad, dim))])
    return corpus.reshape(n_shards, n_local, dim), n_local


def shard_corpus_view(corpus, n_shards: int, *, quantize: str | None = None):
    """Contiguous-block placement of a whole ``CorpusView``.

    ``corpus`` is raw (N, dim) rows or a prebuilt (possibly quantized)
    view. Returns ``(rows, sq, inv, scales, zero_points, n_local)`` stacked
    (S, n_local, dim) / (S, n_local); a field the view lacks is an
    (S, 0) stack. The norms and dequant parameters shard with the rows.

    The real rows' view is the one ``as_corpus_view(corpus, quantize)``
    builds for the unsharded search, so every owned lane sees the same
    metadata. Pad rows stay inert in every residency: raw rows are padded
    with the view of zero rows (codes that dequantize to exact zeros), a
    prebuilt view with code 0, scale 1 and zero point 0. Either way a pad
    row has norm 0, inverse norm ``rsqrt(NORM_EPS)`` and cosine distance
    1.0.
    """
    view = as_corpus_view(corpus, quantize=quantize)  # validates the mode
    n, dim = view.rows.shape
    n_local = math.ceil(n / n_shards)
    pad = n_shards * n_local - n
    if pad:
        dev = view.rows.device
        if isinstance(corpus, CorpusView):
            fill = CorpusView(
                rows=torch.zeros((pad, dim), dtype=view.rows.dtype, device=dev),
                sq_norms=torch.zeros(pad, device=dev),
                inv_norms=torch.full((pad,), NORM_EPS, device=dev).rsqrt(),
                scales=(None if view.scales is None
                        else torch.ones(pad, device=dev)),
                zero_points=(None if view.zero_points is None
                             else torch.zeros(pad, device=dev)))
        else:
            fill = as_corpus_view(
                torch.zeros((pad, dim), dtype=corpus.dtype, device=dev),
                quantize=quantize)
        view = CorpusView(*(None if a is None else torch.cat([a, f])
                            for a, f in zip(view, fill)))

    def stack(a):
        if a is None:
            return torch.zeros((n_shards, 0), dtype=torch.float32,
                               device=view.rows.device)
        return a.reshape(n_shards, n_local, *a.shape[1:])

    return (*(stack(a) for a in view), n_local)


# --------------------------------------------------------------------------
# training on a mesh: specs, placement
# --------------------------------------------------------------------------
# ZeRO stage for LM params: 3 = params FSDP+TP sharded (default);
# 1 = params TP-only (replicated over data; the optimizer state stays FSDP
# sharded).
ZERO_STAGE = 3

# weight name -> role
_IN_OUT = {  # (d_in, d_out) matrices: shard d_in over fsdp, d_out over tp
    "wq", "wk", "wv", "w_gate", "w_up", "q_a", "q_b", "kv_a", "k_b", "v_b",
    "proj", "embed_head",
}
_OUT_IN = {"wo", "w_down"}  # (d_in_tp_product, d_out): tp on axis 0
_TABLES = {"embed", "item_emb", "pos_emb", "table", "linear"}  # (vocab, d)
_REPL = {"router", "bias", "cin_out"}


class P(tuple):
    """A PartitionSpec: one entry a dimension, ``None`` (replicated), an
    axis name, or a tuple of axis names (the dimension split over their
    product, the first axis major). Dimensions past the spec's length are
    replicated. As JAX's, a tuple of one axis is that axis and an empty
    tuple is None."""

    def __new__(cls, *parts):
        def norm(e):
            if isinstance(e, (tuple, list)):
                return None if not e else e[0] if len(e) == 1 else tuple(e)
            return e

        return super().__new__(cls, map(norm, parts))

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: which block of a tensor each position holds."""

    mesh: Mesh
    spec: P

    def _entries(self, ndim: int) -> list[tuple[str, ...]]:
        if len(self.spec) > ndim:
            raise ValueError(f"spec {self.spec} is longer than the tensor's "
                             f"{ndim} dimensions")
        return [_axes(e) for e in self.spec] + [()] * (ndim - len(self.spec))

    def _splits(self, shape) -> list[int]:
        sizes = self.mesh.shape
        out = []
        for dim, axes in zip(shape, self._entries(len(shape))):
            n = math.prod(sizes[a] for a in axes)
            if dim % n:
                raise ValueError(f"dimension {dim} does not split over "
                                 f"{axes} ({n} ways) in spec {self.spec}")
            out.append(n)
        return out

    def block_shape(self, shape) -> tuple[int, ...]:
        return tuple(d // n for d, n in zip(shape, self._splits(shape)))

    def global_shape(self, block_shape) -> tuple[int, ...]:
        sizes = self.mesh.shape
        return tuple(d * math.prod(sizes[a] for a in axes) for d, axes in
                     zip(block_shape, self._entries(len(block_shape))))

    def block_slices(self, shape, pos: tuple[int, ...]) -> tuple[slice, ...]:
        """The global slices of the block at ``pos``."""
        coord = dict(zip(self.mesh.axis_names, pos))
        sizes = self.mesh.shape
        out = []
        for dim, n, axes in zip(shape, self._splits(shape),
                                self._entries(len(shape))):
            idx = 0
            for a in axes:  # row-major over the entry's axes
                idx = idx * sizes[a] + coord[a]
            step = dim // n
            out.append(slice(idx * step, (idx + 1) * step))
        return tuple(out)

    def replica_id(self, pos: tuple[int, ...]) -> int:
        """0 for the first of the positions that hold the same block
        (row-major over the axes the spec does not use), as JAX's
        ``Shard.replica_id``."""
        used = {a for e in self.spec for a in _axes(e)}
        rid = 0
        for a, size, c in zip(self.mesh.axis_names, self.mesh.axis_sizes,
                              pos):
            if a not in used:
                rid = rid * size + c
        return rid


def shard_tensor(t: torch.Tensor, sharding: NamedSharding
                 ) -> tuple[torch.Tensor, ...]:
    """One contiguous copy of its block a mesh position, in row-major
    order, each on its position's device (JAX's ``device_put``)."""
    mesh = sharding.mesh
    out = []
    for pos in mesh.positions():
        src = t[sharding.block_slices(t.shape, pos)]
        blk = torch.empty(src.shape, dtype=t.dtype, device=mesh.device_at(pos))
        out.append(blk.copy_(src))
    return tuple(out)


def gather_tensor(blocks, sharding: NamedSharding, *, device=None,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """The whole tensor from its blocks (each position's block written
    once, replicas skipped), on ``device`` (default: the first position's)
    or into ``out``: the inverse of :func:`shard_tensor`."""
    mesh = sharding.mesh
    positions = mesh.positions()
    shape = sharding.global_shape(blocks[0].shape)
    if out is None:
        dev = mesh.device_at(positions[0]) if device is None else device
        out = torch.empty(shape, dtype=blocks[0].dtype, device=dev)
    with torch.no_grad():
        for pos, blk in zip(positions, blocks):
            if sharding.replica_id(pos) == 0:
                out[sharding.block_slices(shape, pos)].copy_(blk)
    return out


@dataclasses.dataclass
class Placed:
    """A tensor laid out on a mesh: one block a position, in row-major
    order (JAX's global array). ``Placed.blocks[i]`` lives on the device of
    position ``mesh.positions()[i]``."""

    blocks: tuple
    sharding: NamedSharding

    @property
    def shape(self) -> tuple[int, ...]:
        return self.sharding.global_shape(self.blocks[0].shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].dtype

    def gather(self, device=None) -> torch.Tensor:
        return gather_tensor(self.blocks, self.sharding, device=device)

    def unique_blocks(self) -> list[torch.Tensor]:
        """The blocks of replica 0: each element once."""
        return [b for pos, b in zip(self.sharding.mesh.positions(),
                                    self.blocks)
                if self.sharding.replica_id(pos) == 0]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest``: dicts, lists and named tuples are containers, anything else
    (a tensor, a :class:`P`, a sharding, an int) a leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v, *(getattr(r, f) for r in rest))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def place(tree, shardings):
    """Each tensor of ``tree`` (a module reads as its parameters) cut onto
    its sharding's mesh as a :class:`Placed`; other leaves, and leaves
    whose sharding is None, pass through."""
    if isinstance(tree, torch.nn.Module):
        tree = named(tree)

    def one(x, s):
        if s is None or not isinstance(x, torch.Tensor):
            return x
        return Placed(shard_tensor(x.detach(), s), s)

    return tree_map(one, tree, shardings)


def gather(tree, device=None):
    """The whole tensors of a tree of :class:`Placed` leaves."""
    return tree_map(lambda x: x.gather(device) if isinstance(x, Placed)
                    else x, tree)


def _divisible(dim: int, axes, mesh: Mesh) -> bool:
    if axes is None:
        return True
    axes = (axes,) if isinstance(axes, str) else axes
    return dim % math.prod(mesh.shape[a] for a in axes) == 0


def _maybe(dim: int, axes, mesh: Mesh) -> Any:
    """Use the axes only if they divide the dim (else replicate that dim)."""
    return axes if _divisible(dim, axes, mesh) else None


def _param_spec(name: str, shape, mesh: Mesh, tp: str,
                fsdp: tuple[str, ...], stacked: bool) -> P:
    keys = name.split(".")
    key = keys[-1]
    # JAX reads the first dimension of any leaf under a "blocks" key as the
    # layer axis. The LMs' layers are stacked there and one tensor a layer
    # here, so the port's spec is JAX's without that axis; the
    # recommenders' encoder blocks are a list in both, and JAX's rule (so
    # the port's) still takes their first dimension for the layer axis.
    lead = (None,) if not stacked and any("blocks" in k for k in keys) else ()
    body = tuple(shape[len(lead):])

    def build(*ax):
        ax = ax[:len(body)] + (None,) * (len(body) - len(ax))
        return P(*lead, *(a if _divisible(d, a, mesh) else None
                          for a, d in zip(ax, body)))

    if key in _REPL or len(body) <= 1:
        return P(*((None,) * len(shape)))
    if key in _TABLES:
        return build(tp, fsdp)
    if len(body) == 3 and key in ("w_gate", "w_up", "w_down"):
        # MoE expert stacks (E, a, b): EP over tp when divisible,
        # otherwise shard the wide ffn dim over tp.
        if body[0] % mesh.shape[tp] == 0:
            return (build(tp, None, fsdp) if key == "w_down"
                    else build(tp, fsdp, None))
        return (build(None, tp, fsdp) if key == "w_down"
                else build(None, fsdp, tp))
    if key in _OUT_IN:
        return build(tp, fsdp)
    if key in _IN_OUT:
        return build(fsdp, tp)
    if len(body) == 2:  # unknown 2-D weights (the recommenders' MLPs)
        return build(fsdp, tp)
    return P(*((None,) * len(shape)))


def lm_param_specs(params, mesh: Mesh, *, tp: str = "model",
                   fsdp: tuple[str, ...] = ("data",),
                   stacked: bool = True) -> dict[str, P]:
    """``{parameter name: P}`` of a module (or a name -> tensor map; meta
    tensors will do). The rule reads the last part of the name, as JAX's
    reads the last key of the path. ``stacked``: JAX stacks each
    ``blocks.<i>.*`` weight on a leading layer axis (the LMs), and the
    port's spec is JAX's without it; ``False`` for a family whose blocks
    are a list in JAX too (the recommenders)."""
    fsdp = tuple(fsdp)
    return {n: _param_spec(n, t.shape, mesh, tp, fsdp, stacked)
            for n, t in named(params).items()}


def replicated_specs(tree) -> dict:
    if isinstance(tree, torch.nn.Module):
        tree = named(tree)
    return tree_map(lambda t: P(*((None,) * t.ndim)), tree)


def opt_state_specs(param_specs: dict, opt_state: AdamWState,
                    params=None) -> AdamWState:
    """AdamW's state: master, m and v follow the parameter's spec; a
    quantized moment's scales get it with the last axis replicated."""

    def moment(ps: P, mm):
        if isinstance(mm, dict):  # quantized {"q", "scale"}
            return {"q": ps, "scale": P(*ps[:-1], None) if len(ps) else P()}
        return ps

    return AdamWState(
        step=P(), master=dict(param_specs),
        m={n: moment(ps, opt_state.m[n]) for n, ps in param_specs.items()},
        v={n: moment(ps, opt_state.v[n]) for n, ps in param_specs.items()})


def to_named(specs, mesh: Mesh):
    return tree_map(lambda s: NamedSharding(mesh, s), specs)


def batch_axes(mesh: Mesh) -> tuple[str, ...]:
    """The data-parallel axes present in this mesh (pod first if any)."""
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def all_axes(mesh: Mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data", "model") if a in mesh.shape)


# --------------------------------------------------------------------------
# activation sharding constraints: values unchanged (see the docstring)
# --------------------------------------------------------------------------
@contextlib.contextmanager
def activation_mesh(mesh: Mesh | None, dp: tuple[str, ...] = ()):
    yield


def constrain(x, spec: P):
    return x


def constrain_batch(x, *, batch_dim: int = 0):
    return x


def constrain_axis(x, dim: int, axes: tuple[str, ...] = ("model",)):
    return x


def constrain_moe_buf(x, expert_parallel: bool):
    return x


def constrain_seq(x, *, batch_dim: int = 0, seq_dim: int = 1,
                  seq_axes: tuple[str, ...] = ("model",)):
    return x
