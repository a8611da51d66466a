"""granite-20b and deepseek-coder-33b (``configs/granite_20b.py``,
``configs/deepseek_coder_33b.py``) on the port against the JAX package.

Their smoke configs are the dense transformer at MQA (granite: 4 query
heads over 1 kv head) and GQA (deepseek-coder: 8 over 2, head_dim 8). The
same NumPy weights, drawn in JAX's tree (``jax.eval_shape`` of its
``init_params``), go into JAX's functions and into the port's model
(``convert.transformer_from_numpy``); the same token ids go through both on
the CPU. Tolerances are ``tests/test_torch_decode.py``'s: logits, caches
and embeddings within atol 2e-5 and rtol 2e-4 (JAX's
``test_decode_matches_forward``), the loss within rtol 1e-6, each gradient
within 1e-5 x its leaf's max |gradient|. JAX's functions are compiled at
XLA's lowest backend optimisation level: the same operations, compiled in
less time.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import deepseek_coder_33b as jdc
from repro.configs import granite_20b as jgr
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import deepseek_coder_33b as tdc
from repro_torch.configs import granite_20b as tgr
from repro_torch.models import transformer as TT

CPU = "cpu"
ATOL, RTOL = 2e-5, 2e-4
MODULES = {"granite-20b": (jgr, tgr), "deepseek-coder-33b": (jdc, tdc)}
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The models here are tiny: torch's intra-op threads cost more than
    they save when the suite runs its files side by side. Restored after
    the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _draw(tree, seed):
    """Weights in JAX's tree, drawn with numpy: the token table normal x
    0.02, the norms' gains 1 + 0.1 normal, matrices normal / sqrt(fan-in)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        key = jax.tree_util.keystr(path)
        if "norm" in key:
            a = 1.0 + 0.1 * rng.standard_normal(x.shape)
        elif key == "['embed']":
            a = 0.02 * rng.standard_normal(x.shape)
        else:
            a = rng.standard_normal(x.shape) / np.sqrt(x.shape[-2])
        return np.asarray(jnp.asarray(a, x.dtype))

    return jax.tree_util.tree_map_with_path(leaf, tree)


@functools.cache
def _pair(arch):
    """(JAX's smoke config, its params as numpy, the port's model)."""
    jmod, tmod = MODULES[arch]
    jcfg = jmod.smoke()
    params = _draw(jax.eval_shape(lambda k: JT.init_params(k, jcfg),
                                  jax.random.PRNGKey(0)), seed=5)
    return jcfg, params, convert.transformer_from_numpy(params, tmod.smoke(),
                                                        device=CPU)


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def _close(got, want, atol=ATOL, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


@pytest.mark.parametrize("arch", list(MODULES))
def test_configs_are_jax_field_for_field(arch):
    jmod, tmod = MODULES[arch]
    for name in ("full", "smoke"):
        want = dataclasses.asdict(getattr(jmod, name)())
        got = dataclasses.asdict(getattr(tmod, name)())
        wd, gd = want.pop("dtype"), got.pop("dtype")
        assert got == want, name
        assert str(gd).split(".")[-1] == jnp.dtype(wd).name, name
    assert (tmod.SPEC.name, tmod.SPEC.family) == (jmod.SPEC.name, "lm")


@pytest.mark.parametrize("arch", list(MODULES))
def test_forward_and_embed_pool_match_jax(arch):
    """Logits of every position, and the pooled, normalised embedding (D's
    use of the model)."""
    jcfg, params, model = _pair(arch)
    toks = _tokens(jcfg.vocab, (3, 17), seed=1)
    jlogits, jemb = _compiled(lambda p, t: (JT.forward(p, t, jcfg).logits,
                                            JT.embed_pool(p, t, jcfg)),
                              params, toks)(params, toks)
    t = torch.from_numpy(toks)
    with torch.no_grad():
        _close(TT.forward(model, t).logits, jlogits)
        emb = TT.embed_pool(model, t)
    assert emb.shape == (3, jcfg.embed_dim)
    _close(emb, jemb)


@pytest.mark.parametrize("arch", list(MODULES))
def test_loss_fn_and_grads_match_jax(arch):
    jcfg, params, model = _pair(arch)
    toks = _tokens(jcfg.vocab, (2, 13), seed=2)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    (jloss, jm), jgrads = _compiled(jax.value_and_grad(
        lambda p: JT.loss_fn(p, batch, jcfg), has_aux=True), params)(params)
    loss, m = TT.loss_fn(model, batch)
    grads = torch.autograd.grad(loss, list(model.parameters()),
                                allow_unused=True)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-6)
    np.testing.assert_allclose(float(m["ce"].detach()), float(jm["ce"]),
                               rtol=1e-6)
    got = convert.transformer_to_numpy(  # the unused embed_head's is 0
        {n: torch.zeros_like(p) if g is None else g
         for (n, p), g in zip(model.named_parameters(), grads)})
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(jgrads),
                            jax.tree_util.tree_leaves(got)):
        w = np.asarray(w)
        assert g.shape == w.shape, path
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max(), path


@pytest.mark.parametrize("arch", list(MODULES))
def test_prefill_and_decode_match_jax(arch):
    """``prefill`` of 8 tokens into a cache of 12, then two
    ``decode_step``s: logits and every cache tensor against JAX's, and the
    port's decode against its own forward."""
    jcfg, params, model = _pair(arch)
    toks = _tokens(jcfg.vocab, (2, 10), seed=3)
    jl, jc = _compiled(lambda p, t: JT.prefill(p, t, jcfg, max_seq=12),
                       params, toks[:, :8])(params, toks[:, :8])
    decode = _compiled(lambda p, t, c: JT.decode_step(p, t, c, jcfg),
                       params, toks[:, 8:9], jc)
    t = torch.from_numpy(toks)
    lg, c = TT.prefill(model, t[:, :8], max_seq=12)
    assert c.k.shape == (2, 2, 12, jcfg.n_kv_heads, jcfg.head_dim)
    _close(lg, jl)
    for got, want in zip(convert.kv_cache_to_numpy(c)[:2], jc[:2]):
        _close(got, want)
    steps = [lg[:, 0]]
    for i in (8, 9):
        jl, jc = decode(params, toks[:, i:i + 1], jc)
        lg, c = TT.decode_step(model, t[:, i:i + 1], c)
        _close(lg, jl)
        k, v, n = convert.kv_cache_to_numpy(c)
        _close(k, jc.k)
        _close(v, jc.v)
        assert n == np.asarray(jc.length) == i + 1
        steps.append(lg[:, 0])
    with torch.no_grad():
        ref = TT.forward(model, t).logits
    for got, pos in zip(steps, (7, 8, 9)):
        _close(got, ref[:, pos])
