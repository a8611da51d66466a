"""The port's towers against ``repro.models.transformer``.

JAX draws the weights (``init_params(PRNGKey(s), cfg)``), they cross as
numpy arrays through ``convert.transformer_from_numpy``, and the same numpy
token rows go through JAX's ``forward`` / ``embed_pool`` and the port's on
CPU tensors. Tolerances: f32 2e-5 (JAX's own ``test_models.py``); bf16
2e-2 with cosine >= 0.999 per embedding, the smoke's limits, and hidden
states and logits within 2e-2 of their RMS as a whole (JAX
rounds q·scale and P to bf16 inside its attention, the port's plain
attention does not, so single elements differ by a few bf16 ulps).

JAX's initialiser compiles once per weight shape (~5 s a config on one
core), so each config's weights are drawn once per process.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import bimetric_paper as jcfgs
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import bimetric_paper as tcfgs
from repro_torch.models import transformer as TT
from repro_torch.serve.engine import EmbedTower

CPU = "cpu"
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _port_cfg(jcfg):
    return TT.TransformerConfig(**{**dataclasses.asdict(jcfg),
                                   "dtype": DTYPES[np.dtype(jcfg.dtype).name]})


def _gqa_bf16():
    return JT.TransformerConfig(
        name="gqa-bf16-smoke", n_layers=2, d_model=128, n_heads=8,
        n_kv_heads=2, head_dim=16, d_ff=256, vocab=300, qk_norm=True,
        dtype=jnp.bfloat16, embed_dim=64, rope_theta=1e6)


CASES = {
    "cheap_tower_smoke": (jcfgs.cheap_tower_smoke, 2, 12),
    "gqa_bf16_qk_norm": (_gqa_bf16, 3, 20),
    "cheap_tower": (jcfgs.cheap_tower, 2, 16),
}


@functools.cache
def _pair_models(make_cfg, seed=0):
    jcfg = make_cfg()
    params = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    np_params = jax.tree.map(np.asarray, params)
    model = convert.transformer_from_numpy(np_params, _port_cfg(jcfg),
                                           device=CPU)
    return jcfg, params, model


def _tokens(rng, b, s, vocab):
    return rng.integers(0, vocab, (b, s), dtype=np.int32)


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(
        x, np.float32)


def _check_embeddings(got, want, bf16):
    got, want = _f32(got), _f32(want)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    if bf16:
        assert np.abs(got - want).max() <= 2e-2
        assert (np.sum(got * want, axis=1) >= 0.999).all()
    else:
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("case", list(CASES))
def test_forward_and_embed_pool_match_jax(case):
    make_cfg, b, s = CASES[case]
    jcfg, params, model = _pair_models(make_cfg)
    bf16 = jcfg.dtype == jnp.bfloat16
    toks = _tokens(np.random.default_rng(len(case)), b, s, jcfg.vocab)
    # one compile for both entry points
    jout, jemb = jax.jit(lambda p, t: (JT.forward(p, t, jcfg),
                                       JT.embed_pool(p, t, jcfg)))(params, toks)
    with torch.no_grad():
        tout = TT.forward(model, torch.from_numpy(toks))
        temb = TT.embed_pool(model, torch.from_numpy(toks))
    assert tout.hidden.dtype == model.cfg.dtype
    assert tout.logits.shape == (b, s, jcfg.vocab)
    for field in ("hidden", "logits"):
        got, want = _f32(getattr(tout, field)), _f32(getattr(jout, field))
        if bf16:
            rms = lambda a: float(np.sqrt(np.mean(a * a)))
            assert rms(got - want) <= 2e-2 * rms(want), field
        else:
            np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5,
                                       err_msg=field)
    assert float(tout.aux_loss) == 0.0 and float(tout.z_loss) == 0.0
    assert temb.dtype == torch.float32 and temb.shape == (b, jcfg.embed_dim)
    _check_embeddings(temb, jemb, bf16)


def test_out_of_range_token_ids_read_jax_rows():
    """-1 wraps to V-1, V and V+3 clamp to V-1, -V-3 wraps to -3 and clamps
    to 0: the rows JAX's gather reads."""
    jcfg, params, model = _pair_models(jcfgs.cheap_tower_smoke)
    v = jcfg.vocab
    toks = np.array([[-1, v, v + 3, 5, -v - 3, 0, v - 1, 2]], np.int32)
    want = jax.jit(lambda p, t: JT.forward(p, t, jcfg, with_logits=False))(
        params, toks).hidden
    with torch.no_grad():
        got = TT.forward(model, torch.from_numpy(toks), with_logits=False)
    assert got.logits is None
    np.testing.assert_allclose(_f32(got.hidden), _f32(want), atol=2e-5,
                               rtol=2e-5)
    ids = TT.lookup_ids(torch.from_numpy(toks), v)
    assert ids.tolist() == [[v - 1, v - 1, v - 1, 5, 0, 0, v - 1, 2]]


def test_embed_tower_batches_equal_one_call():
    """N not a multiple of the batch: padded, sliced off, and equal to one
    ``embed_pool`` over all rows; JAX's EmbedTower gives the same rows."""
    from repro.serve.engine import EmbedTower as JEmbedTower

    jcfg, params, model = _pair_models(jcfgs.cheap_tower_smoke)
    toks = _tokens(np.random.default_rng(3), 11, 9, jcfg.vocab)
    tower = EmbedTower(model, device=CPU)
    assert tower.cfg is model.cfg
    got = tower.embed(toks, batch=4)
    assert got.shape == (11, jcfg.embed_dim) and got.dtype == np.float32
    with torch.no_grad():
        one = TT.embed_pool(model, torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, one, atol=1e-6, rtol=1e-6)
    _check_embeddings(torch.from_numpy(got),
                      JEmbedTower(params, jcfg).embed(toks, batch=4), False)


@pytest.mark.parametrize("name", ["expensive_tower", "cheap_tower",
                                  "cheap_tower_smoke"])
def test_tower_configs_equal_jax(name):
    jcfg, tcfg = getattr(jcfgs, name)(), getattr(tcfgs, name)()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(_port_cfg(jcfg))
    assert [f.name for f in dataclasses.fields(TT.TransformerConfig)] == [
        f.name for f in dataclasses.fields(JT.TransformerConfig)]
    assert {f.name: f.default for f in dataclasses.fields(
        TT.TransformerConfig) if f.name != "dtype"} == {
        f.name: f.default for f in dataclasses.fields(JT.TransformerConfig)
        if f.name != "dtype"}


def test_from_numpy_refuses_a_pytree_of_another_shape():
    jcfg, params, _ = _pair_models(jcfgs.cheap_tower_smoke)
    np_params = jax.tree.map(np.asarray, params)
    cfg = _port_cfg(jcfg)
    with pytest.raises(ValueError, match="only one of"):
        convert.transformer_from_numpy(
            {k: v for k, v in np_params.items() if k != "embed_head"}, cfg,
            device=CPU)
    with pytest.raises(ValueError, match="embed"):
        convert.transformer_from_numpy(
            dict(np_params, embed=np_params["embed"][:-1]), cfg, device=CPU)


def test_init_params_draws_jax_distributions_and_is_seeded():
    cfg = tcfgs.cheap_tower_smoke()
    a, b = (TT.init_params(4, cfg, device=CPU) for _ in range(2))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    c = TT.init_params(5, cfg, device=CPU)
    assert not torch.equal(a.embed, c.embed)
    assert abs(float(a.embed.detach().std()) - 0.02) < 1e-3
    w = a.blocks[0].ffn.w_down.detach()
    assert abs(float(w.std()) - cfg.d_ff ** -0.5) < 0.01
    assert bool((a.blocks[1].ln2 == 1).all())
