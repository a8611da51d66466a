"""Meshes of named axes; the counterpart of ``repro.launch.mesh``.

Single pod: (data=16, model=16), 256 chips. Multi-pod: (pod=2, data=16,
model=16), 512 chips; the leading "pod" axis carries data parallelism (or
pipeline stages, see ``distributed/pipeline.py``).

One controller drives every position of a mesh, as it drives the shards of
``search_mesh``: a :class:`Mesh` names the torch device of each position,
and one device may stand at several positions (``devices=["cuda:0"] * 4``
puts a (2, 2) mesh on one card). A mesh without devices is abstract, as
JAX's ``AbstractMesh``: it serves for specs only, and placing onto it
raises.

JAX's ``axis_types_kw`` and ``shard_map`` are version shims of jax and have
no counterpart: the port's collectives take the tensors of every shard, in
shard order, where JAX's take an ``axis_name``.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from repro_torch.kernels.backend import resolve_device


class Mesh:
    """Named axes of given sizes and, unless abstract, the device of each
    position (a numpy object array of ``torch.device`` shaped like the
    axes). ``shape`` maps each axis name to its size, as JAX's
    ``Mesh.shape`` does."""

    def __init__(self, axis_sizes: Sequence[int], axis_names: Sequence[str],
                 devices: np.ndarray | None = None):
        self.axis_sizes = tuple(int(s) for s in axis_sizes)
        self.axis_names = tuple(axis_names)
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.axis_sizes} does not match "
                             f"its axes {self.axis_names}")
        if devices is not None:
            devices = np.asarray(devices, dtype=object)
            if devices.shape != self.axis_sizes:
                raise ValueError(f"mesh of shape {self.axis_sizes} got "
                                 f"devices shaped {devices.shape}")
            kinds = {d.type for d in devices.flat}
            if len(kinds) != 1:
                raise ValueError(f"mesh devices mix types: {sorted(kinds)}")
        self.devices = devices

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def abstract(self) -> bool:
        return self.devices is None

    def positions(self) -> list[tuple[int, ...]]:
        """Every position, in row-major order (the order of blocks)."""
        return list(np.ndindex(*self.axis_sizes))

    def device_at(self, pos: tuple[int, ...]) -> torch.device:
        if self.devices is None:
            raise ValueError("an abstract mesh has no devices to place onto")
        return self.devices[pos]

    def _key(self):
        devs = None if self.devices is None else tuple(self.devices.flat)
        return self.axis_names, self.axis_sizes, devs

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        where = "abstract" if self.devices is None else str(
            sorted({str(d) for d in self.devices.flat}))
        return f"Mesh({self.shape}, {where})"


def _devices_of(n: int, device) -> list[torch.device]:
    """The first ``n`` devices of ``device``'s type (the cards unless
    ``"cpu"``; the CPU counts as one device); raises when there are
    fewer."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        have = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        have = [dev]
    if len(have) < n:
        one = f"'{dev.type}:0'" if dev.type == "cuda" else f"'{dev.type}'"
        raise ValueError(
            f"the mesh needs {n} devices, have {len(have)} (put several "
            f"positions on one device with devices=[{one}] * {n})")
    return have[:n]


def make_mesh(shape, axes, devices=None, *, device=None) -> Mesh:
    """A mesh of ``shape`` over ``axes``. ``devices`` lists the device of
    each position in row-major order (all of one type); without it the
    mesh takes the first devices of ``device``'s type and raises when there
    are fewer."""
    n = math.prod(shape)
    if devices is None:
        devs = _devices_of(n, device)
    else:
        devs = [torch.device(d) for d in devices]
        if len(devs) != n:
            raise ValueError(f"a mesh of shape {tuple(shape)} needs {n} "
                             f"devices, got {len(devs)}")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(shape, axes, arr.reshape(tuple(shape)))


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    """(data=16, model=16), or (pod=2, data=16, model=16): 256 or 512
    devices, which one card's host does not have."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices)


def make_host_mesh(n_data: int = 2, n_model: int = 4, *, devices=None,
                   device=None) -> Mesh:
    """A small (data, model) mesh over the devices there are (the cards
    unless ``device="cpu"``, or ``devices``), clamped as JAX clamps it:
    ``n_model`` to the device count, ``n_data`` to what is left."""
    if devices is None:
        dev = resolve_device(device)
        devices = (_devices_of(torch.cuda.device_count(), dev)
                   if dev.type == "cuda" else [dev])
    n = len(devices)
    n_model = min(n_model, n)
    n_data = max(1, min(n_data, n // n_model))
    return make_mesh((n_data, n_model), ("data", "model"),
                     list(devices)[:n_data * n_model])


def axis_size(mesh: Mesh, axis_name: str) -> int:
    """The size of a named axis (JAX's ``axis_size`` inside ``shard_map``
    reads the axis of the program it runs in; the port's caller names the
    mesh)."""
    return mesh.shape[axis_name]
