"""Deterministic, checkpointable data pipeline, the counterpart of
``repro.data.pipeline``.

The iterator's cursor is a tiny dict (seed + step), so a restarted job can
replay the *exact* sample stream from the failure point (no skipped or
duplicated batches). Batches are generated host-side with NumPy, so they are
byte for byte the JAX package's for each (seed, step), and optionally placed
on a device, with a prefetch depth so host generation runs ahead of the
consumer. JAX's iterator takes ``sharding=``; this one takes ``device=``.
"""
from __future__ import annotations

import collections
import threading
from typing import Callable, Iterator

import numpy as np
import torch

from repro_torch.kernels.backend import as_tensor


class DeterministicIterator:
    """Stateful wrapper: batch = make_batch(seed, step); NumPy arrays, or
    tensors on ``device`` when one is given."""

    def __init__(self, make_batch: Callable[[int, int], dict], *,
                 seed: int = 0, start_step: int = 0,
                 device: str | torch.device | None = None, prefetch: int = 2):
        self.make_batch = make_batch
        self.seed = seed
        self.step = start_step
        self.device = None if device is None else torch.device(device)
        self.prefetch = prefetch
        self._queue: collections.deque = collections.deque()
        self._lock = threading.Lock()

    # --- checkpointable cursor ------------------------------------------
    def state(self) -> dict:
        return {"seed": self.seed, "step": self.step - len(self._queue)}

    @classmethod
    def from_state(cls, make_batch, state: dict, **kw) -> "DeterministicIterator":
        return cls(make_batch, seed=state["seed"], start_step=state["step"], **kw)

    # --- iteration --------------------------------------------------------
    def _produce(self) -> dict:
        batch = self.make_batch(self.seed, self.step)
        self.step += 1
        if self.device is not None:
            batch = {k: as_tensor(x, self.device) for k, x in batch.items()}
        return batch

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        with self._lock:
            while len(self._queue) < self.prefetch:
                self._queue.append(self._produce())
            return self._queue.popleft()


def lm_batch_fn(batch: int, seq_len: int, vocab: int):
    def make(seed: int, step: int) -> dict:
        rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
        toks = rng.integers(0, vocab, size=(batch, seq_len + 1), dtype=np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    return make


def contrastive_batch_fn(batch: int, seq_len: int, vocab: int):
    def make(seed: int, step: int) -> dict:
        rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
        q = rng.integers(0, vocab, size=(batch, seq_len), dtype=np.int32)
        d = q.copy()
        tail = seq_len // 2
        d[:, tail:] = rng.integers(0, vocab, size=(batch, seq_len - tail),
                                   dtype=np.int32)
        return {"query_tokens": q, "doc_tokens": d}

    return make
