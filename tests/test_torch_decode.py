"""The port's decode path and LM loss against ``repro.models``.

The same NumPy weights and inputs go through the JAX package and the port on
the CPU (the port's ``flash_decode`` runs its plain version there):

* ``layers.decode_attention`` at H = Hkv, GQA (4 query heads over 2 kv
  heads) and MQA, with a length per batch row;
* ``prefill`` and two ``decode_step``s of ``qwen3_0_6b.smoke()`` (qk-norm,
  GQA) with JAX's weights (``convert.transformer_from_numpy``): the logits
  and every cache tensor (``convert.kv_cache_to_numpy``) within JAX's own
  ``test_decode_matches_forward`` limits (atol 2e-5, rtol 2e-4), and the
  port's decode against its own forward within the same;
* ``cross_entropy``, ``chunked_cross_entropy`` (with a remainder chunk) and
  ``loss_fn`` with its gradients against ``jax.grad``;
* ``init_cache``'s shapes and dtypes, and ``flash_decode``'s refusal of head
  counts that do not divide;
* MoE, MLA and MTP (the granite-moe and deepseek-v3 smoke configs, JAX's
  ``MLA_CFG``): ``prefill`` and ``decode_step`` on the MLA cache over MoE
  blocks, also from a JAX cache; decode = forward at ``capacity_factor=16``
  (JAX's ``test_decode_matches_forward``; GQA over MoE blocks too);
  ``loss_fn`` with its aux, z and MTP terms and its gradients, dense and
  chunked; the MLA cache's layout.

Decode rows of length 0 are left out: JAX gives NaN there, the kernel 0
(``ROADMAP.md``, queue 3).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import deepseek_v3_671b as jd
from repro.configs import granite_moe_3b_a800m as jg
from repro.configs import qwen3_0_6b as jq
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import deepseek_v3_671b as td
from repro_torch.configs import granite_moe_3b_a800m as tg
from repro_torch.configs import qwen3_0_6b as tq
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT

CPU = "cpu"
ATOL, RTOL = 2e-5, 2e-4  # JAX's test_decode_matches_forward


@functools.cache
def _jax_params(seed=0):
    params = JT.init_params(jax.random.PRNGKey(seed), jq.smoke())
    return jax.tree.map(np.asarray, params)


def _model():
    return convert.transformer_from_numpy(_jax_params(), tq.smoke(),
                                          device=CPU)


def _close(got, want, atol=ATOL, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


@pytest.mark.parametrize("h,hkv", [(4, 4), (4, 2), (4, 1)])
def test_decode_attention_matches_jax(h, hkv):
    rng = np.random.default_rng(h * 10 + hkv)
    b, s, dh = 3, 37, 32
    q = rng.standard_normal((b, 1, h, dh), np.float32)
    k = rng.standard_normal((b, s, hkv, dh), np.float32)
    v = rng.standard_normal((b, s, hkv, dh), np.float32)
    lens = np.array([1, 20, s], np.int32)
    want = JL.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               length=jnp.asarray(lens))
    got = TL.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v),
                              length=torch.from_numpy(lens))
    assert got.shape == (b, 1, h, dh) and got.dtype == torch.float32
    _close(got, want)
    # one length for every row, and a scale
    want = JL.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               length=17, scale=0.3)
    got = TL.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), length=17, scale=0.3)
    _close(got, want)


def test_flash_decode_refuses_heads_that_do_not_divide():
    q = torch.zeros(2, 6, 16)
    k = torch.zeros(2, 9, 4, 16)
    with pytest.raises(ValueError, match="6 query heads over 4 kv heads"):
        fa.flash_decode(q, k, k, length=3)
    with pytest.raises(ValueError, match="disagree"):
        fa.flash_decode(q, k, torch.zeros(2, 9, 3, 16), length=3)


def test_prefill_and_decode_match_jax():
    cfg_j = jq.smoke()
    toks = np.random.default_rng(0).integers(0, cfg_j.vocab, (2, 12),
                                             dtype=np.int32)
    params = jax.tree.map(jnp.asarray, _jax_params())
    jlg0, jc = JT.prefill(params, jnp.asarray(toks[:, :8]), cfg_j, max_seq=12)
    jlg1, jc1 = JT.decode_step(params, jnp.asarray(toks[:, 8:9]), jc, cfg_j)
    jlg2, jc2 = JT.decode_step(params, jnp.asarray(toks[:, 9:10]), jc1, cfg_j)

    model = _model()
    t = torch.from_numpy(toks)
    lg0, c = TT.prefill(model, t[:, :8], max_seq=12)
    assert lg0.shape == (2, 1, cfg_j.vocab) and int(c.length) == 8
    _close(lg0, jlg0)
    for name, got, want in zip("kv", convert.kv_cache_to_numpy(c)[:2], jc[:2]):
        _close(got, want, atol=ATOL, rtol=RTOL)
    k_ptr = c.k.data_ptr()
    lg1, c = TT.decode_step(model, t[:, 8:9], c)
    _close(lg1, jlg1)
    k1, v1, len1 = convert.kv_cache_to_numpy(c)
    _close(k1, jc1.k)
    _close(v1, jc1.v)
    assert len1 == np.asarray(jc1.length) == 9 and len1.dtype == np.int32
    lg2, c = TT.decode_step(model, t[:, 9:10], c)
    _close(lg2, jlg2)
    k2, v2, len2 = convert.kv_cache_to_numpy(c)
    _close(k2, jc2.k)
    _close(v2, jc2.v)
    assert len2 == 10
    assert c.k.data_ptr() == k_ptr  # written in place
    # the port's decode against its own forward, JAX's test's limits
    ref = TT.forward(model, t[:, :10]).logits.detach()
    _close(lg1[:, 0], ref[:, 8].numpy())
    _close(lg2[:, 0], ref[:, 9].numpy())
    _close(lg0[:, 0], ref[:, 7].numpy())


def test_decode_from_a_jax_cache_and_into_a_full_one():
    """A JAX cache carried across (``kv_cache_from_numpy``) decodes as JAX
    does; at a full cache the step writes the last slot, as JAX's
    ``dynamic_update_slice`` clamps."""
    cfg_j = jq.smoke()
    toks = np.random.default_rng(1).integers(0, cfg_j.vocab, (2, 7),
                                             dtype=np.int32)
    params = jax.tree.map(jnp.asarray, _jax_params())
    _, jc = JT.prefill(params, jnp.asarray(toks[:, :6]), cfg_j)  # max_seq 6
    jlg, jc1 = JT.decode_step(params, jnp.asarray(toks[:, 6:7]), jc, cfg_j)
    cache = convert.kv_cache_from_numpy(*(np.asarray(x) for x in jc),
                                        device=CPU)
    lg, c1 = TT.decode_step(_model(), torch.from_numpy(toks[:, 6:7]), cache)
    _close(lg, jlg)
    _close(c1.k.numpy(), jc1.k)
    _close(c1.v.numpy(), jc1.v)


def test_init_cache_shapes_and_dtypes():
    c = TT.init_cache(tq.smoke(), 3, 16, device=CPU)
    assert c.k.shape == c.v.shape == (2, 3, 16, 2, 32)
    assert c.k.dtype == torch.float32 and int(c.length) == 0
    assert c.length.shape == () and c.length.dtype == torch.int32
    j = JT.init_cache(jq.smoke(), 3, 16, length=5)
    c = TT.init_cache(tq.full(), 2, 8, length=5, device=CPU)
    assert c.k.shape == (28, 2, 8, 8, 128) and c.k.dtype == torch.bfloat16
    assert int(c.length) == int(j.length) == 5
    assert c.v.shape == c.k.shape and c.v.dtype == c.k.dtype


def test_qwen3_configs_are_jax_field_for_field():
    for name in ("full", "smoke"):
        want = dataclasses.asdict(getattr(jq, name)())
        got = dataclasses.asdict(getattr(tq, name)())
        wd, gd = want.pop("dtype"), got.pop("dtype")
        assert got == want, name
        assert str(gd).split(".")[-1] == jnp.dtype(wd).name, name


def test_cross_entropy_and_chunked_match_jax():
    rng = np.random.default_rng(3)
    b, s, d, v = 2, 11, 16, 40
    hidden = rng.standard_normal((b, s, d), np.float32)
    embed = rng.standard_normal((v, d), np.float32)
    labels = rng.integers(0, v, (b, s), dtype=np.int32)
    logits = hidden @ embed.T
    want = JT.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    got = TT.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    _close(got, want, atol=1e-6, rtol=1e-6)
    for chunk in (4, 64):  # two chunks and a remainder of 3; one, past S
        want, (gh, ge) = jax.value_and_grad(
            lambda hh, ee: JT.chunked_cross_entropy(
                hh, ee, jnp.asarray(labels), chunk), argnums=(0, 1))(
                    jnp.asarray(hidden), jnp.asarray(embed))
        h = torch.from_numpy(hidden).requires_grad_(True)
        e = torch.from_numpy(embed).requires_grad_(True)
        got = TT.chunked_cross_entropy(h, e, torch.from_numpy(labels), chunk)
        _close(got, want, atol=1e-6, rtol=1e-6)
        # each chunk's logits recomputed in the backward pass
        got.backward()
        _close(h.grad, gh, atol=1e-6, rtol=1e-5)
        _close(e.grad, ge, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("ce_chunk", [2048, 4])
def test_loss_fn_and_grads_match_jax(ce_chunk):
    """Dense cross entropy (S <= ce_chunk) and the chunked form (S = 10 in
    chunks of 4 and a remainder of 2)."""
    cfg_j = dataclasses.replace(jq.smoke(), ce_chunk=ce_chunk)
    toks = np.random.default_rng(4).integers(0, cfg_j.vocab, (2, 11),
                                             dtype=np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: JT.loss_fn(p, batch, cfg_j), has_aux=True)(
            jax.tree.map(jnp.asarray, _jax_params()))
    model = _model()
    model.cfg = dataclasses.replace(model.cfg, ce_chunk=ce_chunk)
    loss, m = TT.loss_fn(model, batch)
    loss.backward()
    assert set(m) == {"ce", "aux", "z", "loss"} and float(jloss) > 1.0
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-6)
    for key in ("ce", "aux", "z"):
        np.testing.assert_allclose(float(m[key].detach()), float(jm[key]),
                                   rtol=1e-6)
    assert float(m["loss"].detach()) == float(loss.detach())
    got = convert.transformer_to_numpy(  # the unused embed_head's is 0
        {n: torch.zeros_like(p) if p.grad is None else p.grad
         for n, p in model.named_parameters()})
    want = jax.tree.map(np.asarray, jgrads)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree_util.tree_leaves(got)):
        assert g.shape == w.shape, path
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max(), path


# --------------------------------------------------------------------------
# MoE, MLA and MTP: the granite-moe and deepseek-v3 smoke configs and JAX's
# MLA_CFG (tests/test_models.py: MLA, MoE with a shared expert,
# first_dense=1, MTP, capacity_factor=16)
# --------------------------------------------------------------------------
MLA_CFG = dict(
    name="mla", n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=256, moe=True, n_experts=8, top_k=2, moe_d_ff=32,
    n_shared=1, first_dense=1, mla=True, q_lora_rank=32, kv_lora_rank=24,
    qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16, mtp=True,
    capacity_factor=16.0)
MOE_CFGS = {
    "granite_smoke": (jg.smoke, tg.smoke),
    "dsv3_smoke": (jd.smoke, td.smoke),
    "mla_cfg": (lambda: JT.TransformerConfig(**MLA_CFG),
                lambda: TT.TransformerConfig(**MLA_CFG)),
}


def _draw(tree, seed):
    """Weights in JAX's tree (``jax.eval_shape`` of ``init_params``: the
    initialiser compiles per weight shape), drawn with numpy: the token
    table normal x 0.02, matrices normal / sqrt(fan-in), the norms' gains
    1 + 0.1 normal."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        stacked = "blocks" in jax.tree_util.keystr(path[:1])
        if x.ndim - stacked == 1:
            a = 1.0 + 0.1 * rng.standard_normal(x.shape)
        elif jax.tree_util.keystr(path) == "['embed']":
            a = 0.02 * rng.standard_normal(x.shape)
        else:
            a = rng.standard_normal(x.shape) / np.sqrt(x.shape[-2])
        return np.asarray(jnp.asarray(a, x.dtype))

    return jax.tree_util.tree_map_with_path(leaf, tree)


@functools.cache
def _moe_pair(which, **overrides):
    """(JAX config, its params as numpy, the port's model holding them)."""
    jcfg = dataclasses.replace(MOE_CFGS[which][0](), **overrides)
    tcfg = dataclasses.replace(MOE_CFGS[which][1](), **overrides)
    params = _draw(jax.eval_shape(lambda k: JT.init_params(k, jcfg),
                                  jax.random.PRNGKey(3)), seed=3)
    return jcfg, params, convert.transformer_from_numpy(params, tcfg,
                                                        device=CPU)


@functools.cache
def _moe_jax_fns(jcfg):
    return dict(
        prefill=jax.jit(lambda p, t: JT.prefill(p, t, jcfg, max_seq=12)),
        decode=jax.jit(lambda p, t, c: JT.decode_step(p, t, c, jcfg)))


def _moe_tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def test_moe_prefill_and_decode_match_jax():
    """The MLA cache over a dense block and MoE blocks with a shared expert
    (DS-V3's smoke config), two steps; the logits and every cache tensor
    within JAX's limits."""
    jcfg, params, model = _moe_pair("dsv3_smoke")
    toks = _moe_tokens(jcfg.vocab, (2, 12), seed=2)
    fns = _moe_jax_fns(jcfg)
    jl0, jc = fns["prefill"](params, toks[:, :8])
    jl1, jc1 = fns["decode"](params, toks[:, 8:9], jc)
    jl2, jc2 = fns["decode"](params, toks[:, 9:10], jc1)
    t = torch.from_numpy(toks)
    l0, c = TT.prefill(model, t[:, :8], max_seq=12)
    _close(l0, jl0)
    for got, want in zip(convert.kv_cache_to_numpy(c)[:2], jc[:2]):
        _close(got, want)
    ptr = c.k.data_ptr()
    for tok, jl, jcn in ((t[:, 8:9], jl1, jc1), (t[:, 9:10], jl2, jc2)):
        lg, c = TT.decode_step(model, tok, c)
        _close(lg, jl)
        k, v, n = convert.kv_cache_to_numpy(c)
        _close(k, jcn.k)
        _close(v, jcn.v)
        assert n == np.asarray(jcn.length)
    assert c.k.data_ptr() == ptr  # written in place


def test_mla_decode_from_a_jax_cache():
    """A JAX MLA cache carried across (``kv_cache_from_numpy``) decodes as
    JAX does."""
    jcfg, params, model = _moe_pair("dsv3_smoke")
    toks = _moe_tokens(jcfg.vocab, (2, 12), seed=3)
    fns = _moe_jax_fns(jcfg)
    _, jc = fns["prefill"](params, toks[:, :8])
    jl, jc1 = fns["decode"](params, toks[:, 8:9], jc)
    cache = convert.kv_cache_from_numpy(*(np.asarray(x) for x in jc),
                                        device=CPU)
    assert cache.k.shape == (3, 2, 12, 24) and cache.v.shape == (3, 2, 12, 8)
    lg, c1 = TT.decode_step(model, torch.from_numpy(toks[:, 8:9]), cache)
    _close(lg, jl)
    _close(c1.k, jc1.k)
    _close(c1.v, jc1.v)


@pytest.mark.parametrize("which", ["mla_cfg", "granite_smoke"])
def test_moe_decode_equals_forward_at_capacity_16(which):
    """JAX's ``test_decode_matches_forward`` on the port alone: at
    ``capacity_factor=16`` no assignment drops, so a decode step's logits
    equal the forward's at its position."""
    _, _, model = _moe_pair(which, capacity_factor=16.0)
    toks = torch.from_numpy(_moe_tokens(model.cfg.vocab, (2, 12), seed=4))
    _, c = TT.prefill(model, toks[:, :8], max_seq=12)
    lg1, c = TT.decode_step(model, toks[:, 8:9], c)
    lg2, c = TT.decode_step(model, toks[:, 9:10], c)
    with torch.no_grad():
        ref = TT.forward(model, toks[:, :10]).logits
    _close(lg1[:, 0], ref[:, 8].numpy())
    _close(lg2[:, 0], ref[:, 9].numpy())


@functools.cache
def _jax_loss_grad(jcfg):
    return jax.jit(jax.value_and_grad(
        lambda p, b: JT.loss_fn(p, b, jcfg), has_aux=True))


@pytest.mark.parametrize("which,ce_chunk", [("granite_smoke", 2048),
                                            ("dsv3_smoke", 4)])
def test_moe_mtp_loss_fn_and_grads_match_jax(which, ce_chunk):
    """ce, aux, z, mtp_ce (DS-V3) and the total, and every gradient, with
    the cross entropy dense (granite: S <= ce_chunk) and chunked (DS-V3: S =
    11 in chunks of 4 and a remainder; the MTP term's 10 positions too)."""
    jcfg, params, _ = _moe_pair(which)
    jcfg = dataclasses.replace(jcfg, ce_chunk=ce_chunk)
    toks = _moe_tokens(jcfg.vocab, (2, 12), seed=5)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    (jloss, jm), jgrads = _jax_loss_grad(jcfg)(params, batch)
    model = convert.transformer_from_numpy(
        params, dataclasses.replace(MOE_CFGS[which][1](), ce_chunk=ce_chunk),
        device=CPU)
    loss, m = TT.loss_fn(model, batch)
    loss.backward()
    assert set(m) == set(jm) | {"loss"}
    assert ("mtp_ce" in m) == jcfg.mtp
    for key in jm:
        _close(m[key], jm[key], atol=1e-6, rtol=2e-6)
    _close(loss, jloss, atol=1e-6, rtol=2e-6)
    got = convert.transformer_to_numpy(  # the unused embed_head's is 0
        {n: torch.zeros_like(p) if p.grad is None else p.grad
         for n, p in model.named_parameters()})
    want = jax.tree.map(np.asarray, jgrads)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree_util.tree_leaves(got)):
        assert g.shape == w.shape, path
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max() + 1e-12, path
    expert = got["moe_blocks"]["moe"]
    assert np.abs(expert["w_gate"]).max() > 0
    assert np.abs(expert["router"]).max() > 0


def test_mla_cache_layout_is_jax():
    for name in ("full", "smoke"):
        j = JT.init_cache(getattr(jd, name)(), 2, 8, length=5)
        if name == "full":  # the layout alone: (L, B, S, rank) / (..., rope)
            c = TT.init_cache(dataclasses.replace(td.full(), n_layers=2), 2,
                              8, length=5, device=CPU)
            assert c.k.shape == (2, 2, 8, 512) and c.v.shape == (2, 2, 8, 64)
            assert c.k.dtype == torch.bfloat16
            continue
        c = TT.init_cache(td.smoke(), 2, 8, length=5, device=CPU)
        assert c.k.shape == j.k.shape and c.v.shape == j.v.shape
        assert int(c.length) == int(j.length) == 5
