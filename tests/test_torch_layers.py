"""The port's tower layers against ``repro.models.layers``.

The same numpy inputs go through JAX and through ``repro_torch.models.
layers`` on CPU tensors (attention then runs the plain version of the
port's ``flash_attention``; its kernel is held to that plain version on the
card by ``test_torch_cuda.py``). Tolerances: 2e-5 in f32 (JAX's own
``test_models.py``), 2e-2 in bf16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro_torch.models import layers as tl

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
J_ATTN = jax.jit(jl.blockwise_attention,
                 static_argnames=("causal", "block_kv", "q_offset"))


def _pair(a, dtype="float32"):
    """The same values as a JAX array and a CPU tensor (bf16 rounds alike)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dtype == "bfloat16":
        return jnp.asarray(a, jnp.bfloat16), t.to(torch.bfloat16)
    return jnp.asarray(a), t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _normal(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    rng = np.random.default_rng(0)
    x, gamma = _normal(rng, 3, 5, 48, scale=3.0), _normal(rng, 48)
    (jx, tx), (jg, tg) = _pair(x, dtype), _pair(gamma, dtype)
    got = tl.rms_norm(tx, tg)
    assert got.dtype == tx.dtype
    _close(got, jl.rms_norm(jx, jg), TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,offset", [((3, 5, 48), 0.0), ((4, 21, 32), 5.0),
                                          ((2, 64), -3.0)])
def test_layer_norm(shape, offset, dtype):
    """f32 statistics, the population variance and eps 1e-6 (rows with an
    offset mean, and a near-constant row where torch's eps 1e-5 or an
    unbiased variance would miss), then out * gamma + beta cast back."""
    rng = np.random.default_rng(len(shape) + abs(int(offset)))
    x = _normal(rng, *shape, scale=2.0) + offset
    x[(0,) * (len(shape) - 1)] = 3e-3 * _normal(rng, shape[-1])
    gamma, beta = _normal(rng, shape[-1]), _normal(rng, shape[-1])
    (jx, tx), (jg, tg), (jb, tb) = (_pair(a, dtype) for a in (x, gamma, beta))
    got = tl.layer_norm(tx, tg, tb)
    assert got.dtype == tx.dtype
    _close(got, jl.layer_norm(jx, jg, jb), TOL[dtype])


@pytest.mark.parametrize("act", ["relu", "sigmoid", "leaky_relu", "gelu"])
@pytest.mark.parametrize("dims", [(16, 8), (72, 80, 40, 1), (32, 128, 32)])
def test_mlp(dims, act):
    """The activation between layers only: the last layer stays linear
    (its negative outputs survive relu); a 3-D input, as DIN's."""
    rng = np.random.default_rng(len(dims))
    x = _normal(rng, 3, 7, dims[0])
    ws = [_normal(rng, a, b, scale=a ** -0.5) for a, b in zip(dims, dims[1:])]
    bs = [_normal(rng, b, scale=0.1) for b in dims[1:]]
    jact = getattr(jax.nn, act)
    tact = {"relu": torch.relu, "sigmoid": torch.sigmoid,
            "leaky_relu": torch.nn.functional.leaky_relu,
            "gelu": lambda t: torch.nn.functional.gelu(t, approximate="tanh")}
    got = tl.mlp(torch.from_numpy(x), [torch.from_numpy(w) for w in ws],
                 [torch.from_numpy(b) for b in bs], act=tact[act])
    want = jl.mlp(jnp.asarray(x), [jnp.asarray(w) for w in ws],
                  [jnp.asarray(b) for b in bs], act=jact)
    assert got.shape == (3, 7, dims[-1])
    _close(got, want, TOL["float32"])
    if act == "relu":
        assert float(got.min()) < 0


@pytest.mark.parametrize("theta", [1e4, 1e6])
@pytest.mark.parametrize("s,hd", [(7, 16), (64, 64), (33, 128)])
def test_rope(s, hd, theta):
    np.testing.assert_allclose(tl.rope_freqs(hd, theta).numpy(),
                               np.asarray(jl.rope_freqs(hd, theta)),
                               rtol=1e-6)
    rng = np.random.default_rng(s + hd)
    x = _normal(rng, 2, s, 3, hd)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s))
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()),
                        theta)
    _close(got, jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta),
           TOL["float32"])


def test_rope_bf16_positions_1d():
    """Positions (S,) broadcast over the batch, as the port's forward uses
    them, give JAX's (B, S) answer; bf16 in and out."""
    rng = np.random.default_rng(1)
    x = _normal(rng, 2, 40, 4, 32)
    jx, tx = _pair(x, "bfloat16")
    pos = np.broadcast_to(np.arange(40, dtype=np.int32), (2, 40))
    got = tl.apply_rope(tx, torch.arange(40), 1e6)
    assert got.dtype == torch.bfloat16
    _close(got, jl.apply_rope(jx, jnp.asarray(pos), 1e6), TOL["bfloat16"])


@pytest.mark.parametrize("rep", [1, 2, 4])
def test_repeat_kv(rep):
    k = _normal(np.random.default_rng(rep), 2, 9, 3, 8)
    got = tl.repeat_kv(torch.from_numpy(k), rep)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jl.repeat_kv(jnp.asarray(k), rep)))


@pytest.mark.parametrize("shape", [(2, 9, 3, 8), (1, 5, 1, 4), (3, 1, 2, 8)])
@pytest.mark.parametrize("rep", [1, 2, 4])
def test_heads_first_is_jax_repeat_in_kernel_layout(shape, rep):
    """One contiguous copy in (B, H, S, d), heads in ``repeat_kv``'s order,
    also where a view of the input would already have that shape."""
    k = _normal(np.random.default_rng(rep), *shape)
    got = tl.heads_first(torch.from_numpy(k), rep)
    assert got.is_contiguous()
    want = np.asarray(jl.repeat_kv(jnp.asarray(k), rep)).transpose(0, 2, 1, 3)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("rep", [1, 2, 4])
@pytest.mark.parametrize("s,block_kv", [(48, 16), (50, 16), (37, 512)])
def test_blockwise_attention(s, block_kv, rep, causal, dtype):
    """GQA through the repeat, causal and not; block_kv that does and does
    not divide S (it changes nothing in the port)."""
    rng = np.random.default_rng(s * 10 + rep)
    hkv, dh = 2, 16
    q = _normal(rng, 2, s, hkv * rep, dh)
    k, v = _normal(rng, 2, s, hkv, dh), _normal(rng, 2, s, hkv, dh)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    want = J_ATTN(jq, jk, jv, causal=causal, block_kv=block_kv)
    got = tl.blockwise_attention(tq, tk, tv, causal=causal, block_kv=block_kv)
    assert got.shape == (2, s, hkv * rep, dh) and got.dtype == tq.dtype
    _close(got, want, TOL[dtype])


def test_blockwise_attention_scale_and_dv():
    """An explicit scale and a value width other than the key width."""
    rng = np.random.default_rng(5)
    q, k = _normal(rng, 1, 20, 4, 24), _normal(rng, 1, 20, 2, 24)
    v = _normal(rng, 1, 20, 2, 16)
    want = J_ATTN(*map(jnp.asarray, (q, k, v)), causal=True, block_kv=8,
                  scale=0.3)
    got = tl.blockwise_attention(*map(torch.from_numpy, (q, k, v)),
                                 causal=True, scale=0.3)
    _close(got, want, TOL["float32"])


@pytest.mark.parametrize("sq,skv", [(20, 30), (30, 20)])
def test_blockwise_attention_bottom_right_offset(sq, skv):
    """q_offset = Skv - Sq, the kernel's alignment, is JAX's answer (rows
    with no valid key are 0 on both sides)."""
    rng = np.random.default_rng(sq)
    q = _normal(rng, 1, sq, 2, 16)
    k, v = _normal(rng, 1, skv, 2, 16), _normal(rng, 1, skv, 2, 16)
    want = J_ATTN(*map(jnp.asarray, (q, k, v)), causal=True, block_kv=16,
                  q_offset=skv - sq)
    got = tl.blockwise_attention(*map(torch.from_numpy, (q, k, v)),
                                 causal=True, q_offset=skv - sq)
    _close(got, want, TOL["float32"])


@pytest.mark.parametrize("sq,skv,q_offset", [(8, 8, 3), (8, 8, -1),
                                             (4, 12, 0), (12, 4, 0)])
def test_blockwise_attention_raises_on_other_offsets(sq, skv, q_offset):
    q = torch.zeros(1, sq, 2, 8)
    k = v = torch.zeros(1, skv, 2, 8)
    with pytest.raises(ValueError, match="q_offset"):
        tl.blockwise_attention(q, k, v, causal=True, q_offset=q_offset)
    # without the causal mask the offset means nothing, as in JAX
    assert tl.blockwise_attention(q, k, v, causal=False,
                                  q_offset=q_offset).shape == (1, sq, 2, 8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swiglu(dtype):
    rng = np.random.default_rng(2)
    x = _normal(rng, 2, 7, 32)
    ws = [_normal(rng, 32, 96, scale=32 ** -0.5),
          _normal(rng, 32, 96, scale=32 ** -0.5),
          _normal(rng, 96, 32, scale=96 ** -0.5)]
    jx, tx = _pair(x, dtype)
    pairs = [_pair(w, dtype) for w in ws]
    want = jl.swiglu(jx, *(p[0] for p in pairs))
    got = tl.swiglu(tx, *(p[1] for p in pairs))
    assert got.dtype == tx.dtype
    _close(got, want, TOL[dtype])


def test_initialisers_follow_jax_distributions():
    """Shapes, dtypes and scales of the draws (not JAX's bits)."""
    g = torch.Generator().manual_seed(0)
    w = tl.dense_init(g, 256, 512, torch.bfloat16)
    assert w.shape == (256, 512) and w.dtype == torch.bfloat16
    assert abs(float(w.float().std()) - 256 ** -0.5) < 2e-3
    e = tl.embed_init(g, 1000, 64, torch.float32)
    assert e.shape == (1000, 64) and abs(float(e.std()) - 0.02) < 5e-4
    ffn = tl.init_swiglu(g, 32, 96, torch.float32)
    assert [tuple(p.shape) for p in ffn.parameters()] == [(32, 96), (32, 96),
                                                          (96, 32)]
    x = torch.randn(3, 32, generator=g)
    torch.testing.assert_close(ffn(x), tl.swiglu(x, ffn.w_gate, ffn.w_up,
                                                 ffn.w_down))
