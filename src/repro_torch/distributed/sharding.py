"""Search-corpus placement for the sharded beam engine.

``shard_corpus`` splits the corpus into contiguous equal blocks (zero-padded
when the row count does not divide), ``shard_corpus_view`` does the same for
a whole ``CorpusView`` (rows plus norms and dequant parameters), and
``search_mesh`` names the ordered device of each shard.

Global row i lives on shard ``i // n_local`` at local row ``i % n_local``.
Pad rows sit at global ids >= N, which never appear in an adjacency list, so
they are never gathered, scored or marked.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels.backend import (NORM_EPS, CorpusView, as_corpus_view,
                                         resolve_device)

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
