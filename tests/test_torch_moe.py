"""The port's MoE, MLA and MTP against ``repro.models``.

The same NumPy weights and inputs go through the JAX package and the port on
the CPU, weights carried across by ``convert`` (the port's ``flash_attention``
runs its plain version there):

* ``moe.moe_ffn``: the routing (``top_e``) equal exactly, y, aux and z
  within f32 rounding (bf16: a bf16 ulp of the output), over one dispatch
  group (T=100) and 32 groups (T=64), forced drops (``capacity_factor``
  0.25) and none, ``n_shared`` 0 and 1, a zero row (uniform probabilities:
  a full tie, broken to the lower expert id as ``jax.lax.top_k`` does),
  and bf16; its gradients against ``jax.grad``; ``capacity`` and the group
  rule;
* ``forward`` (logits, hidden, aux, z) and ``embed_pool`` of the
  granite-moe and deepseek-v3 smoke configs and of JAX's own ``MLA_CFG``
  (``tests/test_models.py``);
* the ``convert`` round trip of ``moe_blocks``, ``mtp`` and the MLA cache;
  the configs field for field; ``init_params``; ``launch/train.py`` on both
  smoke archs, and its refusal of deepseek-v3-671b at full size.

The decode path and ``loss_fn`` with its MTP term are in
``tests/test_torch_decode.py``.

Each JAX function is jitted once per config (module-scoped caches).
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
from repro.models import moe as JM
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import deepseek_v3_671b as td
from repro_torch.configs import granite_moe_3b_a800m as tg
from repro_torch.launch import train as launch_train
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.train.optimizer import AdamWConfig

CPU = "cpu"
ATOL, RTOL = 2e-5, 2e-4  # JAX's test_decode_matches_forward
# f32 rounding of the same sums in another order: y, the losses, logits
F32_TOL = 2e-5

# JAX's MLA_CFG (tests/test_models.py): MLA, MoE with a shared expert,
# first_dense=1, MTP, capacity_factor=16 (no drops)
MLA_CFG = dict(
    name="mla", n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=256, moe=True, n_experts=8, top_k=2, moe_d_ff=32,
    n_shared=1, first_dense=1, mla=True, q_lora_rank=32, kv_lora_rank=24,
    qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16, mtp=True,
    capacity_factor=16.0)

CFGS = {
    "granite_smoke": (jg.smoke, tg.smoke),
    "dsv3_smoke": (jd.smoke, td.smoke),
    "mla_cfg": (lambda: JT.TransformerConfig(**MLA_CFG),
                lambda: TT.TransformerConfig(**MLA_CFG)),
}


def _close(got, want, atol=ATOL, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=atol,
                               rtol=rtol)


def _draw(tree, seed):
    """Weights in a JAX init's tree (``jax.eval_shape``: its initialiser
    compiles per weight shape, seconds a config), drawn with numpy: the
    token table normal x 0.02, matrices normal / sqrt(fan-in) (the row
    axis, also of stacked and per-expert weights), the norms' gains 1 + 0.1
    normal, where JAX starts them at 1, so that they are tested too."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = jax.tree_util.keystr(path[-1:])
        if x.ndim - ("blocks" in jax.tree_util.keystr(path[:1])) == 1:
            a = 1.0 + 0.1 * rng.standard_normal(x.shape)
        elif "embed'" in name and "head" not in name:
            a = 0.02 * rng.standard_normal(x.shape)
        else:
            a = rng.standard_normal(x.shape) / np.sqrt(x.shape[-2])
        return np.asarray(jnp.asarray(a, x.dtype))

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _nested_to_state(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_nested_to_state(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = convert.tensor_from_numpy(v, CPU)
    return out


# --------------------------------------------------------------------------
# moe_ffn
# --------------------------------------------------------------------------
# name: (T, capacity_factor, n_shared, dtype, zero rows, drops expected):
# one group with forced drops and no shared expert; 32 groups, no drops, a
# shared expert; zero rows (a full tie) in one group; bf16 over 32 groups
MOE_CASES = {
    "one_group_drops": (100, 0.25, 0, "float32", 0, True),
    "groups32_shared": (64, 1.25, 1, "float32", 0, False),
    "zero_rows": (40, 1.25, 1, "float32", 3, None),
    "bf16": (64, 1.25, 1, "bfloat16", 0, None),
}


@functools.cache
def _moe_pair(n_shared, capacity_factor, dtype):
    """(JAX MoEConfig, JAX params as numpy, the port's MoE with them)."""
    jcfg = JM.MoEConfig(n_experts=8, top_k=2, d_model=32, d_ff=48,
                        n_shared=n_shared, capacity_factor=capacity_factor,
                        dtype=getattr(jnp, dtype))
    params = _draw(jax.eval_shape(lambda k: JM.init_moe(k, jcfg),
                                  jax.random.PRNGKey(7)), seed=7)
    tcfg = TM.MoEConfig(**dict(jcfg._asdict(), dtype=getattr(torch, dtype)))
    module = TM.MoE(tcfg, CPU)
    module.load_state_dict(_nested_to_state(params))
    return jcfg, params, module


@functools.cache
def _jax_moe(jcfg):
    def run(params, x):
        out = JM.moe_ffn(params, x, jcfg)
        t = x.reshape(-1, x.shape[-1]).shape[0]
        g = jcfg.n_groups if (t % jcfg.n_groups == 0
                              and t >= jcfg.n_groups) else 1
        logits = (x.reshape(g, t // g, -1).astype(jnp.float32)
                  @ params["router"])
        _, top_e = jax.lax.top_k(jax.nn.softmax(logits, axis=-1),
                                 jcfg.top_k)
        return out, top_e

    return jax.jit(run)


def _moe_input(t, dtype, zero_rows, seed):
    x = np.random.default_rng(seed).standard_normal((t, 32)).astype(
        np.float32)
    x[:zero_rows] = 0.0
    return np.asarray(jnp.asarray(x, getattr(jnp, dtype)))


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_ffn_matches_jax(case):
    t, cf, n_shared, dtype, zero_rows, drops = MOE_CASES[case]
    jcfg, params, module = _moe_pair(n_shared, cf, dtype)
    x = _moe_input(t, dtype, zero_rows, seed=t + n_shared)
    jout, jtop = _jax_moe(jcfg)(params, x)
    xt = convert.tensor_from_numpy(x, CPU)
    with torch.no_grad():
        out = TM.moe_ffn(module, xt.view(2, t // 2, 32), module.cfg)
        again = TM.moe_ffn(module, xt, module.cfg)
    assert out.y.shape == (2, t // 2, 32) and out.y.dtype == xt.dtype
    g = TM.n_groups(module.cfg, t)
    _, _, _, top_e = TM.route(module.router, xt.view(g, t // g, 32), 2)
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(jtop))
    if zero_rows:  # a full tie: the lowest ids, in order
        assert (top_e.view(t, 2)[:zero_rows] == torch.tensor([0, 1])).all()
    if drops is not None:
        c = TM.capacity(module.cfg, t // g)
        row = TM.slots(top_e, 8, c)
        assert bool((row >= 8 * g * c).any()) == drops  # spare rows
    y = out.y.view(t, 32)
    if dtype == "float32":
        _close(y, jout.y, atol=F32_TOL, rtol=F32_TOL)
    else:  # JAX adds in bf16 one slot at a time, the port rounds once
        w = np.asarray(jout.y, np.float32)
        assert np.abs(y.float().numpy() - w).max() <= 2e-2 * np.abs(w).max()
    _close(out.aux_loss, jout.aux_loss, atol=1e-6, rtol=1e-6)
    _close(out.z_loss, jout.z_loss, atol=1e-6, rtol=1e-6)
    assert torch.equal(again.y, y)


def test_moe_grads_match_jax():
    """Gradients of sum(y · r) + aux + z (forced drops, a shared expert, a
    zero row) for x and every weight, router included."""
    jcfg, params, module = _moe_pair(1, 0.25, "float32")
    x = _moe_input(100, "float32", 1, seed=5)
    r = np.random.default_rng(6).standard_normal((100, 32)).astype(np.float32)

    def f(p, xx):
        out = JM.moe_ffn(p, xx, jcfg)
        return (out.y * r).sum() + out.aux_loss + out.z_loss

    jgp, jgx = jax.jit(jax.grad(f, argnums=(0, 1)))(params, x)
    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    module.zero_grad()
    out = TM.moe_ffn(module, xt, module.cfg)
    ((out.y * torch.from_numpy(r)).sum() + out.aux_loss
     + out.z_loss).backward()
    _close(xt.grad, jgx, atol=1e-5, rtol=1e-4)
    want = _nested_to_state(jax.tree.map(np.asarray, jgp))
    for name, p in module.named_parameters():
        w = want[name].numpy()
        assert np.abs(p.grad.numpy() - w).max() <= 1e-5 * np.abs(w).max(), name


def test_capacity_and_group_rule_are_jax():
    for cf in (0.25, 1.25, 4.0):
        jcfg = JM.MoEConfig(n_experts=40, top_k=8, d_model=8, d_ff=8,
                            capacity_factor=cf)
        tcfg = TM.MoEConfig(**dict(jcfg._asdict(), dtype=torch.float32))
        for n in (1, 3, 8, 31, 64, 100, 512, 2048):
            assert TM.capacity(tcfg, n) == JM.capacity(jcfg, n), (cf, n)
    tcfg = TM.MoEConfig(n_experts=8, top_k=2, d_model=8, d_ff=8)
    assert [TM.n_groups(tcfg, t) for t in (8, 31, 32, 64, 100, 96)] == [
        1, 1, 32, 32, 1, 32]


# --------------------------------------------------------------------------
# the transformer with MoE, MLA and MTP
# --------------------------------------------------------------------------
@functools.cache
def _pair(which, **overrides):
    """(JAX config, JAX params as numpy, the port's model with them)."""
    jcfg = dataclasses.replace(CFGS[which][0](), **overrides)
    tcfg = dataclasses.replace(CFGS[which][1](), **overrides)
    params = _draw(jax.eval_shape(lambda k: JT.init_params(k, jcfg),
                                  jax.random.PRNGKey(3)), seed=3)
    return jcfg, params, convert.transformer_from_numpy(params, tcfg,
                                                        device=CPU)


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


@pytest.mark.parametrize("which", list(CFGS))
def test_forward_and_embed_pool_match_jax(which):
    jcfg, params, model = _pair(which)
    toks = _tokens(jcfg.vocab, (2, 12), seed=1)
    jo = jax.jit(lambda p, t: JT.forward(p, t, jcfg))(params, toks)
    with torch.no_grad():
        out = TT.forward(model, torch.from_numpy(toks))
        emb = TT.embed_pool(model, torch.from_numpy(toks))
    _close(out.logits, jo.logits)
    _close(out.hidden, jo.hidden)
    assert out.aux_loss.dtype == out.z_loss.dtype == torch.float32
    assert float(out.aux_loss) > 0 and float(out.z_loss) > 0
    _close(out.aux_loss, jo.aux_loss, atol=1e-6, rtol=1e-6)
    _close(out.z_loss, jo.z_loss, atol=1e-6, rtol=1e-6)
    # JAX's embed_pool on JAX's hidden: mean, head, f32, l2 norm
    pooled = np.asarray(jo.hidden).mean(1)
    if "embed_head" in params:
        pooled = pooled @ params["embed_head"]
    pooled = pooled / np.sqrt((pooled * pooled).sum(-1, keepdims=True) + 1e-9)
    _close(emb, pooled, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("which", ["granite_smoke", "dsv3_smoke"])
def test_convert_round_trip(which):
    """``moe_blocks`` unstack after the dense blocks and stack back, the
    ``mtp`` subtree stays one, both bit for bit; the MLA cache too."""
    jcfg, params, model = _pair(which)
    n_dense = jcfg.first_dense
    assert [b.use_moe for b in model.blocks] == [
        i >= n_dense for i in range(jcfg.n_layers)]
    back = convert.transformer_to_numpy(model)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(params),
                            jax.tree_util.tree_leaves(back)):
        assert g.dtype == w.dtype and np.array_equal(g, w), path
    assert ("mtp" in back) == jcfg.mtp
    cache = JT.init_cache(jcfg, 2, 5, length=3)
    arrays = [np.random.default_rng(0).standard_normal(x.shape).astype(
        np.float32) for x in cache[:2]]
    c = convert.kv_cache_from_numpy(*arrays, cache.length, device=CPU)
    want = TT.init_cache(model.cfg, 2, 5, length=3, device=CPU)
    assert c.k.shape == want.k.shape and c.v.shape == want.v.shape
    k, v, n = convert.kv_cache_to_numpy(c)
    assert np.array_equal(k, arrays[0]) and np.array_equal(v, arrays[1])
    assert n == 3 and n.dtype == np.int32


@pytest.mark.parametrize("module", ["granite_moe_3b_a800m",
                                    "deepseek_v3_671b"])
def test_configs_are_jax_field_for_field(module):
    jm = {"granite_moe_3b_a800m": jg, "deepseek_v3_671b": jd}[module]
    tm = {"granite_moe_3b_a800m": tg, "deepseek_v3_671b": td}[module]
    for name in ("full", "smoke"):
        want = dataclasses.asdict(getattr(jm, name)())
        got = dataclasses.asdict(getattr(tm, name)())
        wd, gd = want.pop("dtype"), got.pop("dtype")
        assert got == want, name
        assert str(gd).split(".")[-1] == jnp.dtype(wd).name, name
        want_moe = getattr(jm, name)().moe_cfg()._asdict()
        got_moe = getattr(tm, name)().moe_cfg()._asdict()
        want_moe.pop("dtype"), got_moe.pop("dtype")
        assert got_moe == want_moe, name
    if module == "deepseek_v3_671b":
        assert dataclasses.asdict(td.OPT) == dataclasses.asdict(jd.OPT)


def test_init_params_draws_jax_distributions_and_is_seeded():
    cfg = td.smoke()
    a, b = (TT.init_params(4, cfg, device=CPU) for _ in range(2))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    moe = a.blocks[2].moe
    assert moe.router.dtype == torch.float32
    assert abs(float(moe.router.detach().std()) - 64 ** -0.5) < 0.02
    assert abs(float(moe.w_down.detach().std()) - 32 ** -0.5) < 0.02
    assert not torch.equal(moe.w_gate[0], moe.w_gate[1])
    assert a.mtp is not None and bool((a.mtp.norm == 1).all())
    assert abs(float(a.mtp.proj.detach().std()) - 128 ** -0.5) < 0.02
    assert bool((a.blocks[0].attn.kv_a_norm == 1).all())


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "deepseek-v3-671b"])
def test_launcher_trains_moe_archs_on_cpu(arch, capsys):
    trainer, out = launch_train.main(["--arch", arch, "--steps", "3",
                                      "--batch", "2", "--seq", "16",
                                      "--device", CPU])
    assert len(out["losses"]) == 3
    assert all(np.isfinite(x) for x in out["losses"])
    assert trainer.step == 3
    assert f"arch={arch} preset=smoke" in capsys.readouterr().out


def test_launcher_refuses_dsv3_full_before_drawing(monkeypatch):
    def never(*a, **k):
        raise AssertionError("a weight was drawn")

    monkeypatch.setattr(TT, "init_params", never)
    with pytest.raises(ValueError, match="bytes"):
        launch_train.main(["--arch", "deepseek-v3-671b", "--preset", "full",
                           "--device", CPU])
    # bf16 weights and gradients, the f32 master copy and moments: 16 bytes
    # for each of its ~671 B parameters
    need = launch_train.train_state_bytes(td.full(), AdamWConfig())
    assert need > 1e13
