"""The port's checkpoint manager and ``Trainer`` restart against
``repro.checkpoint`` and ``repro.train.trainer``.

* JAX's three manager tests (``tests/test_train.py``: round trip with bf16
  and ``extra``, garbage collection and atomicity, the config-hash guard)
  run against the port;
* a checkpoint written by either package's manager is restored by the
  other's bit for bit (a nested dict of f32, bf16 and int32 leaves), and
  ``config_hash(AdamWConfig(...))`` agrees across the packages;
* an error of the async writer surfaces at ``wait()``;
* a ``Trainer`` killed after an async checkpoint and resumed from it by a
  fresh one is bit-equal to an uninterrupted run (losses after the restart, parameters,
  the f32 master, the moments, the error feedback): the quadratic loss with
  int8 moments and top-k error feedback, and InfoNCE on the smoke d tower
  through ``DeterministicIterator.from_state``.
"""
import functools
import json
import os
import shutil

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as JM
from repro.train import optimizer as JO
from repro_torch.checkpoint import manager as TM
from repro_torch.configs import bimetric_paper as tcfgs
from repro_torch.data import pipeline as TP
from repro_torch.models import transformer as TT
from repro_torch.train import contrastive as TC
from repro_torch.train import optimizer as TO
from repro_torch.train import trainer as TTR

CPU = "cpu"


# --------------------------------------------------------------------------
# JAX's manager tests, against the port
# --------------------------------------------------------------------------
def test_checkpoint_roundtrip(tmp_path):
    mgr = TM.CheckpointManager(str(tmp_path), keep=2, config={"a": 1})
    tree = {"x": torch.arange(6).reshape(2, 3).float(),
            "nested": {"y": torch.ones((4,), dtype=torch.bfloat16)}}
    mgr.save(5, tree, extra={"data_state": {"seed": 1, "step": 9}},
             async_=True)
    mgr.wait()
    like = {"x": torch.empty((2, 3), device="meta"),
            "nested": {"y": torch.empty((4,), dtype=torch.bfloat16,
                                        device="meta")}}
    restored, manifest = mgr.restore(like, device_for=lambda path, a: CPU)
    assert torch.equal(restored["x"], tree["x"])
    assert restored["nested"]["y"].dtype == torch.bfloat16
    assert torch.equal(restored["nested"]["y"], tree["nested"]["y"])
    assert manifest["data_state"]["step"] == 9
    # without device_for, each leaf lands on its like leaf's device
    restored, _ = mgr.restore(tree)
    assert restored["x"].device.type == CPU


def test_checkpoint_gc_and_atomicity(tmp_path):
    mgr = TM.CheckpointManager(str(tmp_path), keep=2)
    tree = {"x": torch.zeros((2,))}
    for s in (1, 2, 3, 4):
        mgr.save(s, tree, async_=False)
    assert mgr.all_steps() == [3, 4]
    assert not [d for d in os.listdir(tmp_path) if d.endswith(".tmp")]


def test_checkpoint_config_hash_guard(tmp_path):
    m1 = TM.CheckpointManager(str(tmp_path), config={"lr": 1})
    m1.save(1, {"x": torch.zeros(2)}, async_=False)
    m2 = TM.CheckpointManager(str(tmp_path), config={"lr": 2})
    with pytest.raises(ValueError):
        m2.restore({"x": torch.zeros(2)})
    m2.restore({"x": torch.zeros(2)}, strict_config=False)


def test_restore_errors(tmp_path):
    mgr = TM.CheckpointManager(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        mgr.restore({"x": torch.zeros(2)})
    mgr.save(1, {"x": torch.zeros(2)}, async_=False)
    with pytest.raises(ValueError, match="shape"):
        mgr.restore({"x": torch.zeros(3)})
    with pytest.raises(KeyError, match="missing leaf y"):
        mgr.restore({"x": torch.zeros(2), "y": torch.zeros(2)})


def test_async_write_error_surfaces_at_wait(tmp_path):
    d = tmp_path / "ckpt"
    mgr = TM.CheckpointManager(str(d))
    os.rmdir(d)
    d.write_text("not a directory")
    mgr.save(1, {"x": torch.zeros(2)})  # the writer thread fails
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()  # raised once


def test_save_copies_to_the_host_before_it_returns(tmp_path):
    """The trainer writes its tensors in place after ``save`` returns: the
    checkpoint holds the values at the call."""
    x = torch.zeros(1000)
    mgr = TM.CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": x})
    x.fill_(1.0)
    mgr.wait()
    restored, _ = mgr.restore({"x": torch.empty(1000)})
    assert torch.equal(restored["x"], torch.zeros(1000))


# --------------------------------------------------------------------------
# across the packages
# --------------------------------------------------------------------------
def _arrays():
    rng = np.random.default_rng(0)
    return {"w": rng.standard_normal((3, 5)).astype(np.float32),
            "opt": {"h": rng.standard_normal((7,)).astype(ml_dtypes.bfloat16),
                    "n": rng.integers(-9, 9, (2, 2), dtype=np.int32)}}


def _bits(a) -> bytes:
    return np.asarray(a).tobytes()


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    want = _arrays()
    JM.CheckpointManager(str(tmp_path), config={"lr": 1}).save(
        3, jax.tree.map(jnp.asarray, want), extra={"data_state": {"step": 3}},
        async_=False)
    like = {"w": torch.zeros(3, 5), "opt": {
        "h": torch.zeros(7, dtype=torch.bfloat16),
        "n": torch.zeros(2, 2, dtype=torch.int32)}}
    got, manifest = TM.CheckpointManager(str(tmp_path),
                                         config={"lr": 1}).restore(like)
    assert manifest["data_state"] == {"step": 3} and manifest["step"] == 3
    assert got["opt"]["h"].dtype == torch.bfloat16
    assert got["opt"]["n"].dtype == torch.int32
    from repro_torch.convert import tensor_to_numpy

    for path, w in (("w", want["w"]), ("h", want["opt"]["h"]),
                    ("n", want["opt"]["n"])):
        t = got["w"] if path == "w" else got["opt"][path]
        assert _bits(tensor_to_numpy(t)) == _bits(w), path


def test_port_checkpoint_restores_in_jax(tmp_path):
    from repro_torch.convert import tensor_from_numpy

    want = _arrays()
    tree = {"w": tensor_from_numpy(want["w"], CPU), "opt": {
        k: tensor_from_numpy(v, CPU) for k, v in want["opt"].items()}}
    TM.CheckpointManager(str(tmp_path), config={"lr": 1}).save(
        4, tree, extra={"data_state": {"seed": 2}}, async_=False)
    like = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), want)
    got, manifest = JM.CheckpointManager(str(tmp_path),
                                         config={"lr": 1}).restore(like)
    assert manifest["data_state"] == {"seed": 2}
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree_util.tree_leaves(got)):
        assert g.dtype == w.dtype and _bits(g) == _bits(w), path
    # the same files and manifest keys as JAX's own save
    JM.CheckpointManager(str(tmp_path / "j"), config={"lr": 1}).save(
        4, jax.tree.map(jnp.asarray, want), extra={"data_state": {"seed": 2}},
        async_=False)
    ours = json.loads((tmp_path / "step_00000004" / "manifest.json").read_text())
    theirs = json.loads((tmp_path / "j" / "step_00000004" /
                         "manifest.json").read_text())
    assert ours == theirs


def test_config_hash_of_adamw_config_agrees():
    kw = dict(lr=1e-3, warmup_steps=20, total_steps=300, quantized_state=True)
    assert TM.config_hash(TO.AdamWConfig(**kw)) == JM.config_hash(
        JO.AdamWConfig(**kw))
    assert TM.config_hash(TO.AdamWConfig()) == JM.config_hash(
        JO.AdamWConfig())


# --------------------------------------------------------------------------
# Trainer kill-and-resume, bit for bit
# --------------------------------------------------------------------------
def _quadratic(params, batch):
    r = params["w"][None] - batch["target"]
    loss = (r * r).mean()
    return loss, {"loss": loss}


def _quadratic_case():
    target = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, 8, 16)).astype(np.float32))

    def make(seed, step):
        return {"target": (target * (1 + 0.05 * step)).numpy()}

    opt = TO.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=12,
                         quantized_state=True)
    return _quadratic, {"w": torch.zeros(8, 16)}, opt, make, 0.3


def _info_nce_case():
    cfg = tcfgs.cheap_tower_smoke()
    model = TT.init_params(0, cfg, device=CPU)
    loss = functools.partial(TC.info_nce_loss, temperature=0.2)
    opt = TO.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=12)
    return loss, model, opt, TP.contrastive_batch_fn(4, 8, cfg.vocab), 0.0


def _state(tr):
    return {**{f"p/{n}": p for n, p in TO.named(tr.params).items()},
            **TM.flatten(tr._tree()["opt"], "opt/"),
            **({} if tr.ef is None else TM.flatten(tr.ef, "ef/"))}


@pytest.mark.parametrize("case", [_quadratic_case, _info_nce_case],
                         ids=["quadratic_int8_topk", "info_nce"])
def test_trainer_resume_is_bit_equal(tmp_path, case):
    loss, params, opt, make, topk = case()
    steps, stop, past = 8, 4, 6

    def trainer(ckpt_dir=None):
        return TTR.Trainer(loss, params, opt, TTR.TrainerConfig(
            total_steps=steps, ckpt_dir=ckpt_dir, ckpt_every=stop,
            topk_compress=topk, log_every=100), device=CPU)

    full = trainer()
    want = full.run(TP.DeterministicIterator(make, seed=3), log=None)

    first = trainer(str(tmp_path))
    it = TP.DeterministicIterator(make, seed=3)
    assert first.maybe_restore(it.state()) == it.state()  # no checkpoint yet
    first.run(it, steps=past, data_state_fn=it.state, log=None)
    # killed at step 6, before its final save: the resume reads the async
    # checkpoint of step 4, written while steps 5 and 6 ran
    assert first.manager.all_steps() == [stop, past]
    shutil.rmtree(tmp_path / f"step_{past:08d}")
    del first

    again = trainer(str(tmp_path))
    it = TP.DeterministicIterator(make, seed=3)
    state = again.maybe_restore(it.state())
    assert again.step == stop and state == {"seed": 3, "step": stop}
    got = again.run(TP.DeterministicIterator.from_state(make, state),
                    log=None)
    assert got["losses"] == want["losses"][stop:]
    assert again.opt_state.step == full.opt_state.step == steps
    a, b = _state(again), _state(full)
    assert a.keys() == b.keys() and len(a) > 3
    for path in a:
        assert a[path].dtype == b[path].dtype, path
        assert torch.equal(a[path], b[path]), path
