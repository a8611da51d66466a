"""The port's recommender models against ``repro.models.recsys``.

The same weights cross as numpy arrays into both (the port's module through
``convert.recsys_from_numpy``), and the same numpy batches go
through JAX's functions and the port's on CPU tensors (BST's and BERT4Rec's
attention then runs the plain version of the port's ``flash_attention``,
which ``test_torch_cuda.py`` holds the kernel to on the card).

Tolerances: forward, ``score_candidates`` and loss in f32 within atol 2e-5
and rtol 2e-4 (JAX's ``test_models.py`` holds its attention at 2e-5); a
gradient per leaf within 1e-4 x that leaf's max |gradient| (one attention
call holds 1e-5 in ``test_torch_attention_grad.py``; a model's gradient
also sums over the batch and over the CIN's products, in another order).

The weights are drawn once per config with numpy, in the tree of JAX's
``*_init`` (``jax.eval_shape``: JAX's initialiser compiles per weight shape,
4-6 s a config on one core); each model's forward, loss and gradient are
one compiled JAX function.
"""
import dataclasses
import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import bert4rec as jb4r, bst as jbst, din as jdin
from repro.configs import recsys_common as jcommon, xdeepfm as jxdfm
from repro.models import recsys as JR
from repro_torch import convert
from repro_torch.configs import bert4rec as tb4r, bst as tbst, din as tdin
from repro_torch.configs import recsys_common as tcommon, xdeepfm as txdfm
from repro_torch.models import recsys as R
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

CPU = "cpu"
ATOL, RTOL = 2e-5, 2e-4
GRAD_REL = 1e-4
CUT_VOCAB = 4096
BATCH = 6  # the smoke batch: one compiled JAX function per model
MODELS = ("bst", "din", "bert4rec", "xdeepfm")
CONFIGS = {"bst": (jbst, tbst), "din": (jdin, tdin),
           "bert4rec": (jb4r, tb4r), "xdeepfm": (jxdfm, txdfm)}
JINIT = {"bst": JR.bst_init, "din": JR.din_init, "bert4rec": JR.bert4rec_init,
         "xdeepfm": JR.xdeepfm_init}
JLOSS = {"bst": JR.bst_loss, "din": JR.din_loss, "bert4rec": JR.bert4rec_loss,
         "xdeepfm": JR.xdeepfm_loss}
TLOSS = {"bst": R.bst_loss, "din": R.din_loss, "bert4rec": R.bert4rec_loss,
         "xdeepfm": R.xdeepfm_loss}


def _jfwd(name, p, b, cfg):
    if name == "bst":
        return JR.bst_forward(p, b["hist"], b["target"], cfg)
    if name == "din":
        return JR.din_forward(p, b["hist"], b["target"], cfg)
    if name == "bert4rec":
        return JR.bert4rec_encode(p, b["items"], cfg)
    return JR.xdeepfm_forward(p, b["fields"], cfg)


def _tfwd(name, m, b):
    if name == "bst":
        return R.bst_forward(m, b["hist"], b["target"])
    if name == "din":
        return R.din_forward(m, b["hist"], b["target"])
    if name == "bert4rec":
        return R.bert4rec_encode(m, b["items"])
    return R.xdeepfm_forward(m, b["fields"])


def _cfgs(name, size):
    """(JAX's config, the port's): the smoke config, or the full config's
    widths with the vocab cut to ``CUT_VOCAB`` rows (per field for
    xDeepFM)."""
    jmod, tmod = CONFIGS[name]
    if size == "smoke":
        return jmod.smoke(), tmod.smoke()
    cut = {"field_vocab" if name == "xdeepfm" else "vocab": CUT_VOCAB}
    return (dataclasses.replace(jmod.full(), **cut),
            dataclasses.replace(tmod.full(), **cut))


def _shapes(name, jcfg):
    """JAX's parameter tree of ``jcfg`` as shapes (no compile)."""
    return jax.eval_shape(functools.partial(JINIT[name], cfg=jcfg),
                          jax.random.PRNGKey(0))


@functools.cache
def _params(name, size, seed=0):
    """Weights in JAX's tree (``*_init``'s shapes and dtypes), drawn with
    numpy at JAX's scales: tables normal x 0.02 (the linear column x
    0.01), matrices normal / sqrt(fan-in); the norms' gains 1 + 0.1 normal
    and every bias 0.1 normal, where JAX starts them at 1 and 0, so that
    their gradients and their place in the forward are tested too."""
    jcfg, _ = _cfgs(name, size)
    rng = np.random.default_rng(seed)

    def scaled(key, shape):
        x = rng.standard_normal(shape)
        if key.endswith(("emb']", "['table']")):
            return x * 0.02
        if key.endswith("['linear']"):
            return x * 0.01
        if "['cin']" in key:
            return x / np.sqrt(shape[1])
        if len(shape) == 2:
            return x / np.sqrt(shape[0])
        gain = key.endswith(("['ln1']", "['ln2']", "['final_ln']"))
        return (1.0 if gain else 0.0) + 0.1 * x

    def draw(path, sds):
        return np.asarray(scaled(jax.tree_util.keystr(path), sds.shape),
                          np.float32)

    return jax.tree_util.tree_map_with_path(draw, _shapes(name, jcfg))


def _model(name, size):
    return convert.recsys_from_numpy(_params(name, size), _cfgs(name, size)[1],
                                     device=CPU)


@functools.cache
def _jax_all(name, grads=True):
    """One compiled (forward, loss, and with ``grads`` the gradient of the
    loss) per model."""

    def run(p, batch, cfg):
        if not grads:
            return _jfwd(name, p, batch, cfg), JLOSS[name](p, batch, cfg)[0]
        (loss, _), g = jax.value_and_grad(
            lambda pp: JLOSS[name](pp, batch, cfg), has_aux=True)(p)
        return _jfwd(name, p, batch, cfg), loss, g

    return jax.jit(run, static_argnums=2)


def _jit(fn, cfg_at=3):
    """``fn`` compiled, its config (argument ``cfg_at``) and ``chunk``
    static: one compile costs less than JAX's op-by-op dispatch here."""
    names = ("chunk",) if "chunk" in inspect.signature(fn).parameters else ()
    return jax.jit(fn, static_argnums=cfg_at, static_argnames=names)


def _ids(rng, hi, shape, pad=0.0):
    """int32 ids in [0, hi), a ``pad`` share of them -1."""
    ids = rng.integers(0, hi, shape, dtype=np.int32)
    return np.where(rng.random(shape) < pad, -1, ids).astype(np.int32)


def _batch(name, cfg, b, seed):
    rng = np.random.default_rng(seed)
    label = (rng.random(b) < 0.5).astype(np.float32)
    if name in ("bst", "din"):
        hist = _ids(rng, cfg.vocab, (b, cfg.seq_len), pad=0.2)
        if name == "din":
            hist[0] = -1  # a history that is all padding
        return {"hist": hist, "target": _ids(rng, cfg.vocab, (b,)),
                "label": label}
    if name == "bert4rec":
        return {"items": _ids(rng, cfg.vocab, (b, cfg.seq_len), pad=0.1),
                "mask_pos": _ids(rng, cfg.seq_len, (b, cfg.n_masked)),
                "mask_labels": _ids(rng, cfg.vocab, (b, cfg.n_masked))}
    return {"fields": _ids(rng, cfg.field_vocab, (b, cfg.n_fields)),
            "label": label}


def _torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _close(got, want, atol=ATOL, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


def _grads(model, loss):
    names = [n for n, _ in model.named_parameters()]
    gs = torch.autograd.grad(loss, list(model.parameters()))
    return convert.recsys_to_numpy(dict(zip(names, gs)))


def _grads_close(got_tree, want_tree, rel=GRAD_REL):
    """Per leaf: max |got - want| within ``rel`` x the leaf's max |want|,
    plus 1e-8 x the largest |want| of any leaf, for leaves whose gradient
    is 0 in exact arithmetic (DIN's last attention bias, which its softmax
    does not see): both sides then hold rounding noise only (~1e-10)."""
    got, want = convert._flatten(got_tree), convert._flatten(
        jax.tree.map(np.asarray, want_tree))
    assert got.keys() == want.keys()
    floor = 1e-8 * max(float(np.abs(w).max(initial=0.0))
                       for w in want.values())
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape and np.isfinite(g).all(), path
        err = float(np.abs(g - w).max()) if w.size else 0.0
        assert err <= rel * float(np.abs(w).max(initial=0.0)) + floor, (
            path, err)


# --------------------------------------------------------------------------
# configs and conversion
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", MODELS)
def test_configs_are_jax_field_for_field(name):
    jmod, tmod = CONFIGS[name]
    for which in ("full", "smoke"):
        want = dataclasses.asdict(getattr(jmod, which)())
        got = dataclasses.asdict(getattr(tmod, which)())
        wd, gd = want.pop("dtype"), got.pop("dtype")
        assert got == want, (name, which)
        assert str(gd).split(".")[-1] == jnp.dtype(wd).name
    assert tcommon.RS_SHAPES == jcommon.RS_SHAPES
    assert tcommon.SMOKE_SHAPES == jcommon.SMOKE_SHAPES
    # the port's initialiser gives JAX's tree, shapes and dtypes
    jcfg, tcfg = _cfgs(name, "smoke")
    init = getattr(R, f"{name}_init")
    got = convert.recsys_to_numpy(init(0, tcfg, device=CPU))
    want = _shapes(name, jcfg)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype


@pytest.mark.parametrize("name", MODELS)
def test_round_trip_through_jax(name):
    """JAX's tree -> the port's module -> JAX's tree, exactly; and JAX's
    forward on the returned tree equals its forward on the original."""
    params = _params(name, "smoke")
    jcfg, tcfg = _cfgs(name, "smoke")
    back = convert.recsys_to_numpy(convert.recsys_from_numpy(params, tcfg,
                                                             device=CPU))
    assert (jax.tree.structure(back) == jax.tree.structure(params))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    batch = _batch(name, jcfg, BATCH, seed=2)
    fn = _jax_all(name)
    np.testing.assert_array_equal(np.asarray(fn(back, batch, jcfg)[0]),
                                  np.asarray(fn(params, batch, jcfg)[0]))
    with pytest.raises(ValueError, match="only one of"):
        convert.recsys_from_numpy({k: v for k, v in params.items()
                                   if k != "item_emb" and k != "table"},
                                  tcfg, device=CPU)


# --------------------------------------------------------------------------
# forward, loss and gradients
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", MODELS)
def test_forward_loss_and_grads_match_jax(name):
    """At the smoke config; DIN's batch has a history that is all padding."""
    jcfg, _ = _cfgs(name, "smoke")
    batch = _batch(name, jcfg, BATCH, seed=2)
    jout, jloss, jgrad = _jax_all(name)(_params(name, "smoke"), batch, jcfg)
    model = _model(name, "smoke")
    tb = _torch(batch)
    with torch.no_grad():
        _close(_tfwd(name, model, tb), jout)
    loss, aux = TLOSS[name](model, tb)
    assert loss.dtype == torch.float32 and aux["loss"] is loss
    _close(loss, jloss)
    _grads_close(_grads(model, loss), jgrad)


@pytest.mark.parametrize("name", MODELS)
def test_full_widths_match_jax(name):
    """At the full config's widths with the vocab cut: BST's heads of 4 over
    21 positions and BERT4Rec's of 32 over 200 through the plain attention,
    xDeepFM's CIN 200-200-200; forward and loss."""
    jcfg, _ = _cfgs(name, "full_cut")
    batch = _batch(name, jcfg, 3, seed=2)
    jout, jloss = _jax_all(name, grads=False)(_params(name, "full_cut"),
                                              batch, jcfg)
    model = _model(name, "full_cut")
    with torch.no_grad():
        tb = _torch(batch)
        _close(_tfwd(name, model, tb), jout)
        _close(TLOSS[name](model, tb)[0], jloss)


@pytest.mark.parametrize("name", MODELS)
def test_score_candidates_match_jax_and_forward(name):
    """``*_score_candidates`` for one user against N candidates equals
    JAX's, and (JAX's own check, ``tests/test_models.py``) the port's
    forward on the tiled inputs within 1e-5 x max |score|."""
    jcfg, _ = _cfgs(name, "smoke")
    params, model = _params(name, "smoke"), _model(name, "smoke")
    rng = np.random.default_rng(3)
    n = 40
    if name == "xdeepfm":
        k = jcfg.n_item_fields
        user = _ids(rng, jcfg.field_vocab, (1, jcfg.n_fields - k))
        cand = _ids(rng, jcfg.field_vocab, (n, k))
        want = _jit(JR.xdeepfm_score_candidates)(params, user, cand, jcfg)
        tiled = {"fields": np.concatenate([np.repeat(user, n, 0), cand], 1)}
    else:
        key = "items" if name == "bert4rec" else "hist"
        user = _ids(rng, jcfg.vocab, (1, jcfg.seq_len), pad=0.2)
        cand = _ids(rng, jcfg.vocab, (n,))
        want = _jit(getattr(JR, f"{name}_score_candidates"))(params, user,
                                                             cand, jcfg)
        tiled = {key: np.repeat(user, n, 0), "target": cand}
    with torch.no_grad():
        got = getattr(R, f"{name}_score_candidates")(
            model, torch.from_numpy(user), torch.from_numpy(cand))
        if name == "bert4rec":
            h = R.bert4rec_encode(model, torch.from_numpy(user))[:, -1]
            pointwise = (h @ model.item_emb[torch.from_numpy(cand)].T)[0]
        else:
            pointwise = _tfwd(name, model, _torch(tiled))
    assert got.shape == (n,)
    _close(got, want)
    scale = float(got.abs().max())
    assert float((got - pointwise).abs().max()) <= 1e-5 * scale


# --------------------------------------------------------------------------
# the chunked paths
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n,chunk", [(8, 2), (7, 2)])
def test_bert4rec_loss_chunked(n, chunk):
    """n > chunk and n % chunk == 0: the rows go in chunks (JAX's scan),
    which equals JAX's at the same chunk; n % chunk != 0: one pass. Both
    against the port's unchunked loss and its gradients."""
    jcfg, _ = _cfgs("bert4rec", "smoke")
    batch = _batch("bert4rec", jcfg, n, seed=4)
    model = _model("bert4rec", "smoke")
    tb = _torch(batch)
    loss, _ = R.bert4rec_loss(model, tb, chunk=chunk)
    if n % chunk == 0:
        jloss, _ = _jit(JR.bert4rec_loss, 2)(_params("bert4rec", "smoke"),
                                          batch, jcfg, chunk=chunk)
        _close(loss, jloss)
    whole, _ = R.bert4rec_loss(model, tb, chunk=n)
    _close(loss, whole.detach(), atol=1e-6, rtol=1e-6)
    _grads_close(_grads(model, loss), _grads(model, whole), rel=1e-5)


@pytest.mark.parametrize("n,chunk", [(40, 10), (45, 10)])
def test_xdeepfm_score_candidates_chunked(n, chunk):
    """Chunks of candidates where n > chunk and n % chunk == 0, one pass
    otherwise; both equal JAX's and the port's one pass."""
    jcfg, _ = _cfgs("xdeepfm", "smoke")
    params, model = _params("xdeepfm", "smoke"), _model("xdeepfm", "smoke")
    rng = np.random.default_rng(5)
    k = jcfg.n_item_fields
    user = _ids(rng, jcfg.field_vocab, (1, jcfg.n_fields - k))
    cand = _ids(rng, jcfg.field_vocab, (n, k))
    want = _jit(JR.xdeepfm_score_candidates)(params, user, cand, jcfg,
                                             chunk=chunk)
    with torch.no_grad():
        got = R.xdeepfm_score_candidates(model, torch.from_numpy(user),
                                         torch.from_numpy(cand), chunk=chunk)
        whole = R.xdeepfm_score_candidates(model, torch.from_numpy(user),
                                           torch.from_numpy(cand), chunk=n)
    _close(got, want)
    _close(got, whole, atol=1e-6, rtol=1e-6)


# --------------------------------------------------------------------------
# the bags and the traps
# --------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bags_match_jax(mode):
    """The dense bag (with and without a mask) and the ragged one against
    JAX's; the ragged bag equals the dense one (JAX's
    ``tests/test_models.py``)."""
    rng = np.random.default_rng(6)
    table = rng.standard_normal((50, 8)).astype(np.float32)
    idx = _ids(rng, 50, (6, 5), pad=0.3)
    idx[1] = -1  # an empty bag
    mask = (rng.random((6, 5)) < 0.7).astype(np.float32)
    tt, ti = torch.from_numpy(table), torch.from_numpy(idx)
    dense = R.embedding_bag(tt, ti, mode=mode)
    _close(dense, JR.embedding_bag(table, idx, mode=mode))
    _close(R.embedding_bag(tt, ti, torch.from_numpy(mask), mode=mode),
           JR.embedding_bag(table, idx, mask, mode=mode))
    flat, seg = idx.reshape(-1), np.repeat(np.arange(6, dtype=np.int32), 5)
    seg[-3:] = 9  # past n_bags: dropped, as segment_sum drops them
    ragged = R.embedding_bag_ragged(tt, torch.from_numpy(flat),
                                    torch.from_numpy(seg), 6, mode=mode)
    _close(ragged, JR.embedding_bag_ragged(table, flat, seg, 6, mode=mode))
    seg[-3:] = 5
    ragged = R.embedding_bag_ragged(tt, torch.from_numpy(flat),
                                    torch.from_numpy(seg), 6, mode=mode)
    _close(ragged, dense, atol=1e-6, rtol=1e-6)


def test_din_all_padding_row():
    """A history that is all padding (row 0 of the smoke batch, whose
    gradients ``test_forward_loss_and_grads_match_jax`` holds to JAX's):
    NaN weights after JAX's softmax, 0 after its ``where``; the row scores
    as JAX's, and alone in a batch its gradients are finite."""
    jcfg, _ = _cfgs("din", "smoke")
    batch = _batch("din", jcfg, BATCH, seed=2)
    assert (batch["hist"][0] == -1).all()
    params, model = _params("din", "smoke"), _model("din", "smoke")
    jout, _, _ = _jax_all("din")(params, batch, jcfg)
    with torch.no_grad():
        got = R.din_forward(model, *(torch.from_numpy(batch[k])
                                     for k in ("hist", "target")))
    assert np.isfinite(np.asarray(jout)).all()
    _close(got[0], np.asarray(jout)[0])
    one = {k: v[:1] for k, v in batch.items()}
    grads = _grads(model, R.din_loss(model, _torch(one))[0])
    assert all(np.isfinite(g).all() for g in convert._flatten(grads).values())
    # the padded history's rows get nothing, the target's row does
    g = grads["item_emb"]
    assert np.abs(g[one["target"][0]]).max() > 0
    assert np.abs(np.delete(g, one["target"][0], 0)).max() == 0


def test_bert4rec_gelu_is_jax_tanh_gelu():
    """BERT4Rec's FFN uses ``jax.nn.gelu``'s default, the tanh
    approximation; the exact GELU would miss it by far more than the
    tolerance."""
    x = np.linspace(-4, 4, 801, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(x))
    _close(R._gelu(torch.from_numpy(x)), want, atol=1e-6, rtol=1e-6)
    exact = F.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(exact - want).max() > 10 * ATOL


def test_bst_pads_are_position_rows_and_bert4rec_pads_are_row_zero():
    """BST's padded item is a zero row plus its position embedding; a
    BERT4Rec pad takes row 0, unmasked."""
    model = _model("bst", "smoke")
    cfg = model.cfg
    hist = torch.full((1, cfg.seq_len), -1, dtype=torch.int32)
    target = torch.tensor([3], dtype=torch.int32)
    seq = torch.cat([hist, target[:, None]], 1)
    x = R.embedding_bag(model.item_emb, seq[..., None])
    assert torch.equal(x[0, :-1], torch.zeros_like(x[0, :-1]))
    b4r = _model("bert4rec", "smoke")
    items = torch.randint(0, b4r.cfg.vocab, (2, b4r.cfg.seq_len),
                          generator=torch.Generator().manual_seed(0),
                          dtype=torch.int32)
    zero = items.clone()
    items[:, 3] = -1
    zero[:, 3] = 0
    with torch.no_grad():
        assert torch.equal(R.bert4rec_encode(b4r, items),
                           R.bert4rec_encode(b4r, zero))


def test_bert4rec_serve_top10_matches_jax():
    """``_serve``'s top-10 over the catalogue, in one pass and in row
    chunks, against JAX's two-stage top-k."""
    jcfg, _ = _cfgs("bert4rec", "smoke")
    params, model = _params("bert4rec", "smoke"), _model("bert4rec", "smoke")
    items = _ids(np.random.default_rng(8), jcfg.vocab, (8, jcfg.seq_len))
    jv, ji = _jit(jb4r._serve, 2)(params, {"items": items}, jcfg, chunk=4)
    with torch.no_grad():
        for chunk in (4, 8192):
            v, i = tb4r._serve(model, {"items": items}, chunk=chunk)
            _close(v, jv)
            np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


# --------------------------------------------------------------------------
# the port's training plumbing takes the modules as they are
# --------------------------------------------------------------------------
def test_trainer_and_checkpoints_take_a_recsys_model(tmp_path):
    """Three ``Trainer`` steps of xDeepFM, checkpointed; a fresh trainer
    resumes from the checkpoint to the same parameters, bit for bit."""
    jcfg, _ = _cfgs("xdeepfm", "smoke")
    batches = [_torch(_batch("xdeepfm", jcfg, 8, seed=10 + i))
               for i in range(3)]
    opt = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=3,
                      weight_decay=0.0)
    tcfg = TrainerConfig(total_steps=3, ckpt_dir=str(tmp_path), ckpt_every=3,
                         log_every=10)
    tr = Trainer(R.xdeepfm_loss, _model("xdeepfm", "smoke"), opt, tcfg,
                 device=CPU)
    res = tr.run(iter(batches), log=lambda _: None)
    assert all(np.isfinite(res["losses"]))
    again = Trainer(R.xdeepfm_loss, _model("xdeepfm", "smoke"), opt, tcfg,
                    device=CPU)
    again.maybe_restore()
    assert again.step == 3
    for (n, a), b in zip(tr.params.named_parameters(),
                         again.params.parameters()):
        assert torch.equal(a, b), n


def test_train_launcher_refuses_recsys_archs():
    """As JAX's launcher: it drives the LM family only."""
    from repro_torch.launch import train as launch_train

    for arch in MODELS:
        with pytest.raises(SystemExit, match="drives the LM family"):
            launch_train.main(["--arch", arch, "--device", CPU])


@pytest.mark.parametrize("name", MODELS)
def test_init_without_a_device_raises_on_a_cpu_host(name):
    """The device rule: weights are drawn on the card unless the caller
    asks for the CPU, and with no card that raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: device=None means the card")
    init = getattr(R, f"{name}_init")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init(0, _cfgs(name, "smoke")[1])
    g = torch.Generator().manual_seed(0)  # a generator's device is its own
    assert next(init(g, _cfgs(name, "smoke")[1]).parameters()).device.type == (
        "cpu")
