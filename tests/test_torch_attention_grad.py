"""Gradients of the port's attention against ``jax.grad`` of JAX's.

The same NumPy inputs and cotangent go through ``jax.grad`` of
``repro.models.layers.blockwise_attention`` and through autograd of the
port's ``blockwise_attention`` (its plain version on the CPU): f32, bf16,
causal and not, GQA rep 1 and 2, Sq < Skv with JAX's ``q_offset = Skv - Sq``,
and dv != dh. Then ``flash_attention_bwd_plain`` (the formula the card's
backward kernel computes) against autograd of ``flash_attention_plain``,
rows with no valid key included.

Tolerances: f32 1e-5 abs + 1e-4 rel (the two sum in other orders; JAX's
scan over KV blocks rescales its partial sums). bf16 2e-2 of the largest
|gradient|: JAX rounds q * scale and P to bf16 inside its attention and its
cotangents stay bf16, the port's plain version works in f32 and rounds once.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import layers as TL

DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}

# dtype, causal, B, Sq, Skv, H, Hkv, dh, dv
CASES = [
    ("float32", True, 2, 12, 12, 2, 2, 16, 16),
    ("float32", True, 2, 12, 12, 4, 2, 16, 16),    # GQA rep 2
    ("float32", False, 1, 7, 19, 4, 2, 16, 16),
    ("float32", True, 1, 5, 13, 2, 2, 16, 8),      # Sq < Skv, dv != dh
    ("float32", True, 2, 5, 13, 4, 2, 8, 24),      # ... with GQA
    ("bfloat16", True, 2, 12, 12, 2, 2, 16, 16),
    ("bfloat16", True, 1, 5, 13, 4, 2, 16, 16),
    ("bfloat16", False, 1, 7, 19, 4, 2, 16, 8),
]


def _ids(case):
    dt, causal, b, sq, skv, h, hkv, dh, dv = case
    return (f"{dt}-{'causal' if causal else 'full'}-rep{h // hkv}"
            f"-{sq}x{skv}-{dh}/{dv}")


def _check(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert np.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
    else:
        assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_blockwise_attention_grads_match_jax(case):
    dt, causal, b, sq, skv, h, hkv, dh, dv = case
    jdt, tdt = DT[dt]
    rng = np.random.default_rng(sq * 31 + skv + h + dv)
    q, k, v = (rng.normal(size=s).astype(np.float32) for s in
               ((b, sq, h, dh), (b, skv, hkv, dh), (b, skv, hkv, dv)))
    cot = rng.normal(size=(b, sq, h, dv)).astype(np.float32)
    offset = skv - sq  # where the port's kernel puts the queries

    def jloss(q, k, v):
        out = JL.blockwise_attention(q, k, v, causal=causal, block_kv=8,
                                     q_offset=offset)
        return jnp.sum(out.astype(jnp.float32) * cot)

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        *(jnp.asarray(x, jdt) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).to(tdt).requires_grad_()
                  for x in (q, k, v))
    out = TL.blockwise_attention(tq, tk, tv, causal=causal, block_kv=8,
                                 q_offset=offset)
    assert out.dtype == tdt and out.shape == (b, sq, h, dv)
    (out.float() * torch.from_numpy(cot)).sum().backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), jg):
        assert got.dtype == tdt and got.shape == want.shape
        _check(got, want, dt)


# dtype, causal, B, H, Sq, Skv, dh, dv
PLAIN = [
    ("float32", True, 2, 3, 9, 9, 16, 16),
    ("float32", False, 1, 2, 7, 19, 16, 8),
    ("float32", True, 1, 2, 19, 7, 8, 16),      # Sq > Skv: 12 rows, no key
    ("bfloat16", True, 2, 2, 13, 13, 16, 16),
    ("bfloat16", True, 1, 2, 11, 5, 16, 24),    # Sq > Skv, dv != dh
]


@pytest.mark.parametrize("case", PLAIN)
def test_bwd_plain_equals_autograd_of_plain(case):
    dt, causal, b, h, sq, skv, dh, dv = case
    tdt = DT[dt][1]
    g = torch.Generator().manual_seed(sq + skv + dv)
    q, k, v = (torch.randn(*s, generator=g).to(tdt).requires_grad_()
               for s in ((b, h, sq, dh), (b, h, skv, dh), (b, h, skv, dv)))
    cot = torch.randn(b, h, sq, dv, generator=g).to(tdt)
    out = FA.flash_attention(q, k, v, causal=causal)
    out.backward(cot)
    got = FA.flash_attention_bwd(q.detach(), k.detach(), v.detach(),
                                 out.detach(), cot, causal=causal)
    for x, want in zip(got, (q.grad, k.grad, v.grad)):
        assert x.dtype == tdt and x.shape == want.shape
        _check(x, want.float().numpy(), dt)
    if causal and sq > skv:
        empty = sq - skv
        assert (got[0][:, :, :empty] == 0).all()
        assert (out[:, :, :empty] == 0).all()


def test_bwd_refuses_mismatched_out():
    q = torch.zeros(1, 2, 5, 8)
    with pytest.raises(ValueError, match="dout"):
        FA.flash_attention_bwd(q, q, q, q, torch.zeros(1, 2, 5, 4))
    with pytest.raises(ValueError, match="out"):
        FA.flash_attention_bwd(q, q, q, q.bfloat16(), q)
