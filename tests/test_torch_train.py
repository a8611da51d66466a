"""The port's training step against ``repro.train`` and ``repro.data.pipeline``.

The same NumPy weights, batches and gradients go through the JAX package and
the port on the CPU:

* ``info_nce_loss`` at ``cheap_tower_smoke()``: loss, acc and every
  parameter's gradient by JAX path (``convert.transformer_to_numpy``);
* AdamW (f32 and int8 moments, whose int8 bytes and scales must be JAX's
  exactly), ``lr_schedule``, ``make_sgd``, ``quantize_blockwise`` and
  ``topk_sparsify`` (its mask exactly);
* ``Trainer`` steps of the smoke tower against JAX's ``Trainer`` on the same
  ``contrastive_batch_fn`` batches, and the cases of ``tests/test_train.py``
  that need no checkpoint, on the port alone;
* ``DeterministicIterator``: batches byte-equal to JAX's, and its cursor.

Tolerances (f32): a loss of unrelated rows 1e-5 relative; a gradient leaf
1e-4 of its largest |element| (the InfoNCE temperature 0.05 multiplies the
embeddings' rounding by 20, and the two sum in other orders); optimizer
states 1e-6 relative. ``contrastive_batch_fn``'s pairs share half their
tokens, so a random tower's loss there is ~1e-2, a difference of logits
near 1/T = 20: ``Trainer`` losses are held to 1e-4 absolute plus 1e-3
relative. After AdamW steps a parameter may move by up to lr a step where
its gradient is at the noise floor of the two sums (``m / sqrt(v)`` is then
about ±1 either way), so tower parameters after ``Trainer`` steps are held
to lr/10 a step on all but 1 % of their elements and to 2·lr a step on all.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import bimetric_paper as jcfgs
from repro.data import pipeline as JP
from repro.models import transformer as JT
from repro.train import compression as JCP
from repro.train import contrastive as JC
from repro.train import optimizer as JO
from repro.train import trainer as JTR
from repro_torch import convert
from repro_torch.configs import bimetric_paper as tcfgs
from repro_torch.data import pipeline as TP
from repro_torch.train import compression as TCP
from repro_torch.train import contrastive as TC
from repro_torch.train import optimizer as TO
from repro_torch.train import trainer as TTR

CPU = "cpu"


@functools.cache
def _smoke_params(seed=0):
    params = JT.init_params(jax.random.PRNGKey(seed), jcfgs.cheap_tower_smoke())
    return jax.tree.map(np.asarray, params)


def _smoke_model():
    return convert.transformer_from_numpy(_smoke_params(),
                                          tcfgs.cheap_tower_smoke(), device=CPU)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(x, np.float32)
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else (
        np.asarray(x, np.float32))


# --------------------------------------------------------------------------
# the loss
# --------------------------------------------------------------------------
def test_info_nce_loss_and_grads_match_jax():
    jcfg = jcfgs.cheap_tower_smoke()
    # unrelated query and doc rows: contrastive_batch_fn's pairs share half
    # their tokens, and a random tower already scores them ~13 logits above
    # the negatives, where the loss (~1e-5) is f32 rounding of logits ~20
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, jcfg.vocab, (8, 12), dtype=np.int32)
             for k in ("query_tokens", "doc_tokens")}
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        functools.partial(JC.info_nce_loss, cfg=jcfg), has_aux=True))(
            jax.tree.map(jnp.asarray, _smoke_params()), batch)
    model = _smoke_model()
    loss, aux = TC.info_nce_loss(model, batch)
    loss.backward()
    assert float(jloss) > 1.0
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    assert float(aux["acc"]) == float(jaux["acc"])
    assert float(aux["loss"]) == float(loss.detach())
    got = _leaves(convert.transformer_to_numpy(
        {n: p.grad for n, p in model.named_parameters()}))
    want = _leaves(jgrads)
    assert got.keys() == want.keys()
    for path, w in want.items():
        assert got[path].shape == w.shape, path
        assert np.abs(got[path] - w).max() <= 1e-4 * np.abs(w).max(), path
    # the inverse of transformer_from_numpy, bit for bit
    back = _leaves(convert.transformer_to_numpy(model))
    for path, w in _leaves(_smoke_params()).items():
        assert np.array_equal(back[path], w), path


def test_remat_full_recomputes_blocks_to_the_same_gradients():
    """``remat="full"`` checkpoints each block (JAX's ``jax.checkpoint`` per
    block): the same loss and gradients, bit for bit on the CPU."""
    import dataclasses

    batch = JP.contrastive_batch_fn(4, 8, 512)(1, 0)
    grads = {}
    for remat in ("none", "full"):
        model = _smoke_model()
        model.cfg = dataclasses.replace(model.cfg, remat=remat)
        loss, _ = TC.info_nce_loss(model, batch)
        loss.backward()
        grads[remat] = (loss.detach(), [p.grad for p in model.parameters()])
    assert torch.equal(grads["none"][0], grads["full"][0])
    assert all(torch.equal(a, b) for a, b in zip(grads["none"][1],
                                                  grads["full"][1]))


# --------------------------------------------------------------------------
# the optimizer and compression
# --------------------------------------------------------------------------
def test_lr_schedule_matches_jax():
    cfg = dict(lr=1e-3, warmup_steps=20, total_steps=100)
    jc, tc = JO.AdamWConfig(**cfg), TO.AdamWConfig(**cfg)
    for step in range(0, 121):
        want = float(JO.lr_schedule(jc, jnp.int32(step)))
        got = TO.lr_schedule(tc, step)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=1e-12)


def _opt_case(seed=5):
    rng = np.random.default_rng(seed)
    params = {"w": rng.normal(size=(4, 300)).astype(np.float32),
              "b": rng.normal(size=(300,)).astype(np.float32)}
    grads = [{n: (rng.normal(size=p.shape) * (0.5 + i)).astype(np.float32)
              for n, p in params.items()} for i in range(3)]
    return params, grads


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_adamw_updates_match_jax(quantized):
    """Three updates on the same grads (clipped, decayed where ndim >= 2)."""
    cfg = dict(lr=0.05, warmup_steps=2, total_steps=10, weight_decay=0.1,
               grad_clip=1.0, quantized_state=quantized)
    params, grads = _opt_case()
    j_init, j_upd = JO.make_adamw(JO.AdamWConfig(**cfg))
    t_init, t_upd = TO.make_adamw(TO.AdamWConfig(**cfg))
    jp = {n: jnp.asarray(p) for n, p in params.items()}
    tp = {n: torch.from_numpy(p.copy()) for n, p in params.items()}
    js, ts = j_init(jp), t_init(tp)
    for g in grads:
        jp, js, jstats = j_upd({n: jnp.asarray(x) for n, x in g.items()}, js,
                               jp)
        tp, ts, tstats = t_upd({n: torch.from_numpy(x) for n, x in g.items()},
                               ts, tp)
        np.testing.assert_allclose(float(tstats["grad_norm"]),
                                   float(jstats["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tstats["lr"]), float(jstats["lr"]),
                                   rtol=1e-6)
    assert ts.step == int(js.step) == 3
    for n in params:
        np.testing.assert_allclose(_np(tp[n]), np.asarray(jp[n]), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(_np(ts.master[n]), np.asarray(js.master[n]),
                                   rtol=1e-6, atol=1e-6)
        for mine, theirs in ((ts.m[n], js.m[n]), (ts.v[n], js.v[n])):
            if quantized:
                assert mine["q"].dtype == torch.int8
                assert np.array_equal(mine["q"].numpy(), np.asarray(theirs["q"]))
                assert np.array_equal(mine["scale"].numpy(),
                                      np.asarray(theirs["scale"]))
            else:
                np.testing.assert_allclose(_np(mine), np.asarray(theirs),
                                           rtol=1e-6, atol=1e-9)


def test_quantize_blockwise_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 300)).astype(np.float32)
    x[0, :128] = np.arange(128) - 63.5  # absmax 63.5: halves at +-0.5 steps
    x[1, 128:256] = 0.0
    jq, js = JO.quantize_blockwise(jnp.asarray(x))
    tq, ts = TO.quantize_blockwise(torch.from_numpy(x))
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert np.array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        TO.dequantize_blockwise(tq, ts).numpy(),
        np.asarray(JO.dequantize_blockwise(jq, js)))


def test_sgd_matches_jax():
    params, grads = _opt_case(seed=6)
    j_init, j_upd = JO.make_sgd(0.1)
    t_init, t_upd = TO.make_sgd(0.1)
    jp = {n: jnp.asarray(p) for n, p in params.items()}
    tp = {n: torch.from_numpy(p.copy()) for n, p in params.items()}
    js, ts = j_init(jp), t_init(tp)
    for g in grads:
        jp, js, _ = j_upd({n: jnp.asarray(x) for n, x in g.items()}, js, jp)
        tp, ts, _ = t_upd({n: torch.from_numpy(x) for n, x in g.items()}, ts,
                          tp)
    assert ts.step == 3 and ts.m is None
    for n in params:
        np.testing.assert_array_equal(_np(tp[n]), np.asarray(jp[n]))


def test_topk_sparsify_mask_and_error_feedback_match_jax():
    rng = np.random.default_rng(2)
    shapes = {"w": (6, 40), "b": (40,)}
    jef = JCP.init_error_feedback({n: jnp.zeros(s) for n, s in shapes.items()})
    tef = TCP.init_error_feedback({n: torch.zeros(s) for n, s in shapes.items()})
    for step in range(4):
        g = {n: rng.normal(size=s).astype(np.float32) for n, s in shapes.items()}
        g["b"][:8] = 2.0  # ties at the threshold are all kept
        js, jef, _ = JCP.topk_sparsify({n: jnp.asarray(x) for n, x in g.items()},
                                       jef, k_frac=0.1)
        ts, tef, stats = TCP.topk_sparsify(
            {n: torch.from_numpy(x) for n, x in g.items()}, tef, k_frac=0.1)
        assert stats == {"k_frac": 0.1}
        for n in shapes:
            assert np.array_equal(ts[n].numpy() != 0, np.asarray(js[n]) != 0)
            np.testing.assert_array_equal(ts[n].numpy(), np.asarray(js[n]))
            np.testing.assert_array_equal(tef[n].numpy(), np.asarray(jef[n]))


# the cases of tests/test_train.py that need no checkpoint, on the port
def _quadratic_loss(params, batch):
    r = params["w"] - batch["target"]
    loss = (r * r).sum()
    return loss, {"loss": loss}


def _grad(loss_fn, params):
    leaves = {n: p.detach().requires_grad_() for n, p in params.items()}
    loss = loss_fn(leaves)
    return dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))


def test_adamw_converges():
    cfg = TO.AdamWConfig(lr=0.1, warmup_steps=1, total_steps=200,
                         weight_decay=0.0, grad_clip=1e9)
    init, update = TO.make_adamw(cfg)
    params = {"w": torch.zeros((8, 8))}
    target = torch.ones((8, 8)) * 3.0
    st = init(params)
    for _ in range(150):
        g = _grad(lambda p: _quadratic_loss(p, {"target": target})[0], params)
        params, st, _ = update(g, st, params)
    assert float((params["w"] - target).abs().max()) < 0.15


def test_adamw_quantized_close_to_exact():
    tgt = torch.from_numpy(np.random.default_rng(0).normal(size=(4, 256)) * 2
                           ).float()
    out = {}
    for quant in (False, True):
        cfg = TO.AdamWConfig(lr=0.05, warmup_steps=1, total_steps=500,
                             weight_decay=0.0, grad_clip=1e9,
                             quantized_state=quant)
        init, update = TO.make_adamw(cfg)
        params = {"w": torch.zeros((4, 256))}
        st = init(params)
        for _ in range(100):
            g = _grad(lambda p: _quadratic_loss(p, {"target": tgt})[0], params)
            params, st, _ = update(g, st, params)
        out[quant] = params["w"].numpy()
    err = np.abs(out[True] - out[False]).max()
    assert err < 0.25, err  # int8 states track the exact trajectory


def test_quantize_roundtrip_bound():
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(3, 300))).float()
    q, s = TO.quantize_blockwise(x)
    back = TO.dequantize_blockwise(q, s)
    assert float((back - x).abs().max()) <= float(x.abs().max()) / 127.0 + 1e-6


def test_lr_schedule_shape():
    cfg = TO.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100)
    lrs = [float(TO.lr_schedule(cfg, s)) for s in range(0, 101, 10)]
    assert lrs[0] == 0.0 and max(lrs) <= 1.0
    assert lrs[-1] == pytest.approx(cfg.min_lr_frac, rel=0.05)


def test_topk_error_feedback_converges():
    """Sparsified-with-EF SGD reaches the dense optimum (DGC property)."""
    rng = np.random.default_rng(0)
    A = torch.from_numpy(rng.normal(size=(32, 16))).float()
    b = torch.from_numpy(rng.normal(size=(32,))).float()

    def loss(p):
        r = A @ p["w"] - b
        return (r * r).mean()

    params = {"w": torch.zeros((16,))}
    ef = TCP.init_error_feedback(params)
    for _ in range(400):
        sg, ef, _ = TCP.topk_sparsify(_grad(loss, params), ef, k_frac=0.25)
        params = {n: p - 0.05 * sg[n] for n, p in params.items()}
    dense = {"w": torch.zeros((16,))}
    for _ in range(400):
        g = _grad(loss, dense)
        dense = {n: p - 0.05 * g[n] for n, p in dense.items()}
    with torch.no_grad():
        assert float(loss(params)) < float(loss(dense)) * 1.1 + 1e-4


def test_trainer_grad_accum_equivalence():
    opt = TO.AdamWConfig(lr=0.1, warmup_steps=1, total_steps=100,
                         weight_decay=0.0, grad_clip=1e9)
    target = torch.ones((8, 4))

    def loss(params, batch):
        r = params["w"][None] - batch["target"]
        l = (r * r).mean()
        return l, {"loss": l}

    outs = {}
    for accum in (1, 4):
        tr = TTR.Trainer(loss, {"w": torch.zeros((4,))}, opt,
                         TTR.TrainerConfig(total_steps=5, grad_accum=accum,
                                           log_every=100), device=CPU)

        def gen():
            while True:
                yield {"target": target.clone()}
        tr.run(gen(), steps=5)
        outs[accum] = tr.params["w"].detach().numpy()
    np.testing.assert_allclose(outs[1], outs[4], rtol=1e-4, atol=1e-5)


# --------------------------------------------------------------------------
# the trainer
# --------------------------------------------------------------------------
def test_trainer_steps_match_jax():
    """Three InfoNCE steps of the smoke tower, micro-batched in two: losses
    and every parameter against JAX's ``Trainer`` on the same batches."""
    jcfg = jcfgs.cheap_tower_smoke()
    make = JP.contrastive_batch_fn(16, 4, jcfg.vocab)
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    tcfg = dict(total_steps=3, grad_accum=2, log_every=100)
    jtr = JTR.Trainer(functools.partial(JC.info_nce_loss, cfg=jcfg),
                      jax.tree.map(jnp.asarray, _smoke_params()),
                      JO.AdamWConfig(**opt), JTR.TrainerConfig(**tcfg))
    jres = jtr.run(JP.DeterministicIterator(make, seed=7), log=None)
    model = _smoke_model()
    ttr = TTR.Trainer(TC.info_nce_loss, model, TO.AdamWConfig(**opt),
                      TTR.TrainerConfig(**tcfg), device=CPU)
    tres = ttr.run(TP.DeterministicIterator(make, seed=7), log=None)
    np.testing.assert_allclose(tres["losses"], jres["losses"], rtol=1e-3,
                               atol=1e-4)
    assert ttr.step == 3 and ttr.opt_state.step == 3
    # the trainer owns its copy: the caller's model is untouched
    assert all(torch.equal(a, b) for a, b in zip(
        model.parameters(), _smoke_model().parameters()))
    got = _leaves(convert.transformer_to_numpy(ttr.params))
    lr, steps = opt["lr"], tcfg["total_steps"]
    for path, want in _leaves(jtr.params).items():
        err = np.abs(got[path] - want)
        assert err.max() <= 2 * lr * steps, path
        assert np.mean(err > lr * steps / 10) <= 1e-2, path


def test_trainer_topk_error_feedback_matches_jax():
    """The trainer's error feedback and micro-batches against JAX's on a
    flat parameter dict (JAX's leaves and the port's are then the same
    tensors, so the top-k masks rank the same elements)."""
    rng = np.random.default_rng(3)
    target = rng.normal(size=(4, 8, 16)).astype(np.float32)
    opt = dict(lr=0.05, warmup_steps=1, total_steps=20)
    tcfg = dict(total_steps=4, grad_accum=2, topk_compress=0.25,
                log_every=100)

    def loss(params, batch):
        r = params["w"][None] - batch["target"]
        l = (r * r).mean()
        return l, {"loss": l}

    def batches(conv):
        step = 0
        while True:
            yield {"target": conv(target * (1 + step))}
            step += 1

    jtr = JTR.Trainer(loss, {"w": jnp.zeros((8, 16))}, JO.AdamWConfig(**opt),
                      JTR.TrainerConfig(**tcfg))
    jres = jtr.run(batches(jnp.asarray), log=None)
    ttr = TTR.Trainer(loss, {"w": np.zeros((8, 16), np.float32)},
                      TO.AdamWConfig(**opt), TTR.TrainerConfig(**tcfg),
                      device=CPU)
    tres = ttr.run(batches(torch.from_numpy), log=None)
    np.testing.assert_allclose(tres["losses"], jres["losses"], rtol=1e-6)
    np.testing.assert_allclose(_np(ttr.params["w"]), np.asarray(jtr.params["w"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(ttr.ef["w"]), np.asarray(jtr.ef["w"]),
                               rtol=1e-5, atol=1e-6)


def test_trainer_without_checkpoints():
    opt = TO.AdamWConfig()
    with pytest.raises(NotImplementedError, match="checkpoint"):
        TTR.Trainer(_quadratic_loss, {"w": torch.zeros(2)}, opt,
                    TTR.TrainerConfig(ckpt_dir="anywhere"), device=CPU)
    tr = TTR.Trainer(_quadratic_loss, {"w": torch.zeros(2)}, opt,
                     TTR.TrainerConfig(), device=CPU)
    state = {"seed": 1, "step": 4}
    assert tr.maybe_restore(state) is state and tr.maybe_restore() is None
    assert tr.save(state) is None and tr.manager is None
    if not torch.cuda.is_available():  # the device rule: no silent CPU
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TTR.Trainer(_quadratic_loss, {"w": torch.zeros(2)}, opt,
                        TTR.TrainerConfig())


# --------------------------------------------------------------------------
# the data iterator
# --------------------------------------------------------------------------
@pytest.mark.parametrize("fn", ["lm_batch_fn", "contrastive_batch_fn"])
def test_batches_equal_jax(fn):
    jmake, tmake = getattr(JP, fn)(3, 9, 1000), getattr(TP, fn)(3, 9, 1000)
    for seed, step in ((0, 0), (0, 1), (5, 0), (5, 17)):
        want, got = jmake(seed, step), tmake(seed, step)
        assert got.keys() == want.keys()
        for key in want:
            assert got[key].dtype == want[key].dtype
            assert got[key].tobytes() == want[key].tobytes()


def test_deterministic_iterator_state_resume():
    make = TP.lm_batch_fn(4, 8, 100)
    it1 = TP.DeterministicIterator(make, seed=3, prefetch=2)
    jit1 = JP.DeterministicIterator(JP.lm_batch_fn(4, 8, 100), seed=3,
                                    prefetch=2)
    for _ in range(5):
        a, b = next(it1), next(jit1)
        assert a["tokens"].tobytes() == b["tokens"].tobytes()
    state = it1.state()
    assert state == jit1.state() == {"seed": 3, "step": 5}
    more1 = [next(it1) for _ in range(3)]
    it2 = TP.DeterministicIterator.from_state(make, state, prefetch=2)
    more2 = [next(it2) for _ in range(3)]
    for a, b in zip(more1, more2):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
    on_dev = TP.DeterministicIterator.from_state(make, state, device=CPU)
    first = next(on_dev)
    assert isinstance(first["tokens"], torch.Tensor)
    np.testing.assert_array_equal(first["tokens"].numpy(), more1[0]["tokens"])
