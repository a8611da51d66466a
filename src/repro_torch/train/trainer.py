"""The fault-tolerant training loop, the counterpart of
``repro.train.trainer``.

* a train step with **microbatch gradient accumulation** (the micro-batches'
  gradients summed in order in f32, then divided);
* optional top-k gradient sparsification with error feedback;
* checkpoint/restart: params, the optimizer's state (step, f32 master,
  moments, int8 ones included), the error feedback and the data iterator's
  cursor are saved atomically (``repro_torch.checkpoint``) and restored by
  :meth:`Trainer.maybe_restore` — a killed job resumes at the exact step
  with the exact data stream, bit for bit;
* **straggler watchdog**: per-step wall-time EMA; steps slower than
  ``watchdog_factor`` x EMA are recorded;
* the deterministic data pipeline (``repro_torch.data.pipeline``) feeds it.

PyTorch idiom: the step runs eagerly (JAX jits it); gradients come from
``torch.autograd.grad`` on the trainer's own copy of the params (a module or a
flat dict of tensors), which the optimizer's new values are copied into; a
restore copies the checkpoint into those same tensors. Runs on the card
unless ``device="cpu"``, and raises without one.
"""
from __future__ import annotations

import copy
import dataclasses
import time
from typing import Any, Callable, Iterator

import torch
from torch import nn

from repro_torch.checkpoint.manager import CheckpointManager, flatten
from repro_torch.kernels.backend import as_tensor, resolve_device
from repro_torch.train import compression
from repro_torch.train.optimizer import AdamWConfig, make_adamw, named


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    grad_accum: int = 1
    ckpt_dir: str | None = None
    ckpt_every: int = 50
    keep_ckpts: int = 2
    watchdog_factor: float = 3.0
    topk_compress: float = 0.0  # 0 = off; else fraction of grads communicated
    log_every: int = 10


def _own_copy(params, device: torch.device):
    """The trainer's copy of ``params`` on ``device``: a deep copy of a
    module, or a dict of leaf tensors that require grad."""
    if isinstance(params, nn.Module):
        return copy.deepcopy(params).to(device)
    return {n: as_tensor(p, device).detach().clone().requires_grad_(True)
            for n, p in params.items()}


class Trainer:
    def __init__(
        self,
        loss_fn: Callable[[Any, dict], tuple[torch.Tensor, dict]],
        params: nn.Module | dict,
        opt_cfg: AdamWConfig,
        cfg: TrainerConfig,
        *,
        device=None,
    ):
        self.cfg = cfg
        self.loss_fn = loss_fn
        self.device = resolve_device(device)
        self.opt_init, self.opt_update = make_adamw(opt_cfg)
        # own our copy: the step writes the new values into it
        self.params = _own_copy(params, self.device)
        self.opt_state = self.opt_init(self.params)
        self.ef = (compression.init_error_feedback(self.params)
                   if cfg.topk_compress else None)
        self.step = 0
        self.step_times: list[float] = []
        self.straggler_steps: list[int] = []
        self.manager = (
            CheckpointManager(cfg.ckpt_dir, keep=cfg.keep_ckpts, config=opt_cfg)
            if cfg.ckpt_dir
            else None
        )

    # ------------------------------------------------------------------
    def _value_and_grad(self, batch: dict):
        leaves = named(self.params)
        loss, _ = self.loss_fn(self.params, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        return loss.detach(), {
            n: torch.zeros_like(p) if g is None else g
            for (n, p), g in zip(leaves.items(), grads)}

    def _train_step(self, batch: dict):
        batch = {k: as_tensor(x, self.device) for k, x in batch.items()}
        accum = self.cfg.grad_accum
        if accum > 1:
            mbs = {k: x.reshape(accum, x.shape[0] // accum, *x.shape[1:])
                   for k, x in batch.items()}
            grads = {n: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for n, p in named(self.params).items()}
            loss = torch.zeros((), dtype=torch.float32, device=self.device)
            for i in range(accum):
                l_i, g_i = self._value_and_grad({k: x[i]
                                                 for k, x in mbs.items()})
                grads = {n: grads[n] + g_i[n] for n in grads}
                loss = loss + l_i
            grads = {n: g / accum for n, g in grads.items()}
            loss = loss / accum
        else:
            loss, grads = self._value_and_grad(batch)

        if self.ef is not None:
            grads, self.ef, _ = compression.topk_sparsify(
                grads, self.ef, self.cfg.topk_compress)
        new, self.opt_state, stats = self.opt_update(grads, self.opt_state,
                                                     self.params)
        with torch.no_grad():
            for n, p in named(self.params).items():
                p.copy_(new[n])
        return loss, stats

    # ------------------------------------------------------------------
    def _tree(self) -> dict:
        """What a checkpoint holds: {"params", "opt", "ef"?}, ``opt`` the
        optimizer's state with its step as a 0-d int64 leaf."""
        opt = self.opt_state._replace(step=torch.tensor(self.opt_state.step))
        tree = {"params": named(self.params), "opt": opt}
        if self.ef is not None:
            tree["ef"] = self.ef
        return tree

    def maybe_restore(self, data_state: dict | None = None) -> dict | None:
        """Resume from the latest checkpoint if one exists: its params,
        optimizer state and error feedback are copied into the trainer's
        own tensors, ``step`` is the checkpoint's, and the saved data cursor
        is returned (``data_state`` when there is no checkpoint)."""
        if self.manager is None or self.manager.latest_step() is None:
            return data_state
        tree = self._tree()
        # read onto the host, then copied into place: no second copy of the
        # state on the card
        restored, manifest = self.manager.restore(
            tree, device_for=lambda path, arr: "cpu")
        got = flatten(restored)
        with torch.no_grad():
            for path, t in flatten(tree).items():
                t.copy_(got[path])
        self.opt_state = self.opt_state._replace(step=int(got["opt/step"]))
        self.step = manifest["step"]
        return manifest.get("data_state", data_state)

    def save(self, data_state: dict | None = None, *, sync: bool = False) -> None:
        """Checkpoint the current step (no-op without ``ckpt_dir``, as
        JAX's); every tensor is on the host when this returns."""
        if self.manager is None:
            return
        self.manager.save(self.step, self._tree(),
                          extra={"data_state": data_state or {}},
                          async_=not sync)

    # ------------------------------------------------------------------
    def run(self, batches: Iterator[dict], *, steps: int | None = None,
            data_state_fn: Callable[[], dict] | None = None,
            log: Callable[[str], None] = print) -> dict:
        steps = steps if steps is not None else self.cfg.total_steps
        losses = []
        ema = None
        while self.step < steps:
            batch = next(batches)
            t0 = time.perf_counter()
            loss, stats = self._train_step(batch)
            loss = float(loss)
            dt = time.perf_counter() - t0
            self.step += 1
            self.step_times.append(dt)
            if ema is None:
                ema = dt
            elif dt > self.cfg.watchdog_factor * ema and self.step > 3:
                self.straggler_steps.append(self.step)
            ema = 0.9 * (ema or dt) + 0.1 * dt
            losses.append(loss)
            if self.step % self.cfg.log_every == 0:
                log(
                    f"step {self.step}: loss={loss:.4f} "
                    f"gnorm={float(stats.get('grad_norm', 0)):.3f} {dt*1e3:.0f}ms"
                )
            if self.manager and self.step % self.cfg.ckpt_every == 0:
                self.save(data_state_fn() if data_state_fn else None)
        if self.manager:
            self.save(data_state_fn() if data_state_fn else None, sync=True)
        return {
            "losses": losses,
            "final_loss": losses[-1] if losses else None,
            "stragglers": self.straggler_steps,
        }
