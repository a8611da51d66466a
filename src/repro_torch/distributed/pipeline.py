"""GPipe pipeline parallelism over the stages of a mesh; the counterpart of
``repro.distributed.pipeline``.

JAX writes the pipeline as one ``lax.scan`` over ``n_micro + n_stages - 1``
ticks inside ``shard_map``: at each tick every stage runs its layer group
on the activation it holds and ``ppermute``s the result to its successor.
One controller runs the same schedule here: at tick t, stage s runs
microbatch t - s (stage 0 reads it from the inputs, the others take what
their predecessor handed them with ``.to(device)``), and the last stage
emits it. A stage with no microbatch at a tick (the bubbles) computes
nothing: JAX computes there and masks the result out, so no value changes.
Autograd through the schedule gives the backward pipeline; ``remat`` runs
each stage under ``torch.utils.checkpoint`` (non-reentrant), as JAX wraps
the stage in ``jax.checkpoint``.
"""
from __future__ import annotations

from typing import Any, Callable, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.launch.mesh import Mesh


def _stage_devices(mesh: Mesh, n_stages: int) -> list[torch.device]:
    if mesh.size != n_stages:
        raise ValueError(f"{n_stages} stages on a mesh of {mesh.size} "
                         "positions")
    return [mesh.device_at(pos) for pos in mesh.positions()]


def gpipe_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                stage_params: Sequence, x_micro: torch.Tensor, *,
                mesh: Mesh, n_micro: int, remat: bool = True
                ) -> list[torch.Tensor]:
    """``stage_params[s]``: stage s's parameters (anything ``stage_fn``
    takes), on the device of the mesh's s-th position (row-major).
    ``x_micro``: (n_micro, mb, ...) inputs. Returns the (n_micro, mb, ...)
    outputs once a stage, on each stage's device, as JAX's masked ``psum``
    replicates them."""
    devs = _stage_devices(mesh, len(stage_params))
    n_stages = len(devs)
    fn = ((lambda p, x: checkpoint(stage_fn, p, x, use_reentrant=False))
          if remat else stage_fn)
    held: list[torch.Tensor | None] = [None] * n_stages
    outputs: list[torch.Tensor | None] = [None] * n_micro
    for t in range(n_micro + n_stages - 1):
        handed = [None] * n_stages
        for s in range(n_stages):
            i = t - s  # the microbatch stage s holds at tick t
            if not 0 <= i < n_micro:
                continue  # a bubble
            x = x_micro[i].to(devs[0]) if s == 0 else held[s]
            y = fn(stage_params[s], x)
            if s == n_stages - 1:
                outputs[i] = y
            else:
                handed[s + 1] = y.to(devs[s + 1])
        held = handed
    out = torch.stack(outputs)
    return [out.to(d) for d in devs]


def stack_stage_params(init_fn: Callable[[torch.Generator, torch.device], Any],
                       seed: int, n_stages: int, *, mesh: Mesh) -> list:
    """Stage s's parameters ``init_fn(generator, device)`` on the mesh's
    s-th device, drawn from its own ``torch.Generator`` seeded ``seed +
    s`` (JAX splits one key into a key a stage)."""
    out = []
    for s, dev in enumerate(_stage_devices(mesh, n_stages)):
        g = torch.Generator(device=dev).manual_seed(seed + s)
        out.append(init_fn(g, dev))
    return out
