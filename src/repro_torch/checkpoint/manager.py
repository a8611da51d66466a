"""Fault-tolerant checkpointing: atomic, async, placed anew on restore. The
counterpart of ``repro.checkpoint.manager``, with its layout on disk exactly:

    <dir>/step_00000042.tmp/   — written first
        manifest.json          — step, config hash, leaf index, extra keys
        arrays.npz             — all leaves, keyed by their nested keys
                                 joined with "/"
    <dir>/step_00000042/       — atomic rename after fsync (crash-safe commit)

so each package restores the other's checkpoint of a nested dict of arrays.
bf16 and fp8 leaves are widened to f32 on save (losslessly) and cast back
to the ``like`` leaf's dtype on restore.

A tree is nested dicts, tuples and ``NamedTuple``s (a field keyed by its
name, as JAX's attribute keys) over tensors (or, to save, NumPy arrays);
``None`` is an empty subtree. A save copies every leaf to host memory on the calling
thread before it returns: the trainer writes its parameters and moments in
place, so the next step cannot tear a checkpoint that is still being
written. Only the file writing runs on the worker thread; its error
surfaces at the next :meth:`CheckpointManager.wait`.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from typing import Any, Callable

import numpy as np
import torch

Tree = Any

#: the dtypes that NumPy's npz cannot hold, widened to f32 on save
_WIDENED = (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2)


def config_hash(obj: Any) -> str:
    return hashlib.sha256(repr(obj).encode()).hexdigest()[:16]


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def flatten(tree: Tree, prefix: str = "") -> dict:
    """{"a/b/c": leaf} in the tree's order (dict keys, fields, indices)."""
    if tree is None:
        return {}
    if _is_leaf(tree):
        return {prefix[:-1]: tree}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        raise TypeError(f"checkpoint: leaf {prefix[:-1]!r} is a "
                        f"{type(tree).__name__}, not a tensor or an array")
    out = {}
    for key, val in items:
        out.update(flatten(val, f"{prefix}{key}/"))
    return out


def unflatten(tree: Tree, leaves: dict, prefix: str = "") -> Tree:
    """``tree``'s structure with each leaf taken from ``leaves`` by path."""
    if tree is None:
        return None
    if _is_leaf(tree):
        return leaves[prefix[:-1]]
    if isinstance(tree, dict):
        return {k: unflatten(v, leaves, f"{prefix}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(unflatten(v, leaves, f"{prefix}{k}/")
                            for k, v in zip(tree._fields, tree)))
    return type(tree)(unflatten(v, leaves, f"{prefix}{i}/")
                      for i, v in enumerate(tree))


def _to_host(leaf) -> np.ndarray:
    """A host copy of ``leaf`` that nothing else holds; bf16 and fp8 widened
    to f32. A card's tensor is copied synchronously."""
    if isinstance(leaf, np.ndarray):
        arr = np.array(leaf, copy=True)
        if arr.dtype.name in ("bfloat16", "float8_e4m3fn", "float8_e5m2"):
            arr = arr.astype(np.float32)
        return arr
    t = leaf.detach()
    if t.dtype in _WIDENED:
        t = t.float()  # a copy for a CPU tensor too
        return (t if t.device.type == "cpu" else t.cpu()).numpy()
    return t.to("cpu", copy=True).numpy()


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3,
                 config: Any = None):
        self.directory = directory
        self.keep = keep
        self.config_hash = config_hash(config) if config is not None else None
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        #: seconds of the last save: its copy to the host (on the caller's
        #: thread) and its file writing (on the worker, for an async save)
        self.timings = {"host_copy_s": None, "write_s": None}

    # ------------------------------------------------------------------ save
    def _write(self, step: int, host_leaves: dict[str, np.ndarray],
               extra: dict) -> None:
        t0 = time.perf_counter()
        try:
            name = f"step_{step:08d}"
            tmp = os.path.join(self.directory, name + ".tmp")
            final = os.path.join(self.directory, name)
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            np.savez(os.path.join(tmp, "arrays.npz"), **host_leaves)
            manifest = {
                "step": step,
                "config_hash": self.config_hash,
                "leaves": sorted(host_leaves.keys()),
                **extra,
            }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)  # atomic commit
            self._gc()
            self.timings["write_s"] = time.perf_counter() - t0
        except BaseException as e:  # surfaced on next wait()
            self._error = e

    def save(self, step: int, tree: Tree, *, extra: dict | None = None,
             async_: bool = True) -> None:
        """Write ``tree`` as step ``step``. Every leaf is on the host before
        this returns; with ``async_`` the files are written by a worker
        thread (one at a time: a save first waits for the last)."""
        self.wait()
        t0 = time.perf_counter()
        host = {path: _to_host(leaf) for path, leaf in flatten(tree).items()}
        self.timings = {"host_copy_s": time.perf_counter() - t0,
                        "write_s": None}
        if async_:
            self._thread = threading.Thread(
                target=self._write, args=(step, host, extra or {}), daemon=True
            )
            self._thread.start()
        else:
            self._write(step, host, extra or {})
            self.wait()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.directory):
            if d.startswith("step_") and not d.endswith(".tmp"):
                if os.path.exists(os.path.join(self.directory, d, "manifest.json")):
                    out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like: Tree, *, step: int | None = None,
                device_for: Callable[[str, np.ndarray], Any] | None = None,
                strict_config: bool = True) -> tuple[Tree, dict]:
        """Restore into the structure of ``like`` (a tree of tensors, which
        may be on the ``meta`` device): each leaf a new tensor of its
        ``like`` leaf's dtype, on ``device_for(path, array)`` when given
        (JAX's ``sharding_for``), else on the ``like`` leaf's device.
        Returns (tree, manifest)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        if strict_config and self.config_hash and manifest.get("config_hash"):
            if manifest["config_hash"] != self.config_hash:
                raise ValueError(
                    "checkpoint config hash mismatch: "
                    f"{manifest['config_hash']} != {self.config_hash}"
                )
        out = {}
        with np.load(os.path.join(d, "arrays.npz")) as data:
            for key, leaf in flatten(like).items():
                if key not in data:
                    raise KeyError(f"checkpoint missing leaf {key}")
                arr = data[key]
                if arr.shape != tuple(leaf.shape):
                    raise ValueError(
                        f"{key}: checkpoint shape {arr.shape} != expected "
                        f"{tuple(leaf.shape)}"
                    )
                dev = (device_for(key, arr) if device_for is not None
                       else leaf.device)
                out[key] = torch.from_numpy(arr).to(device=dev,
                                                    dtype=leaf.dtype)
        return unflatten(like, out), manifest
