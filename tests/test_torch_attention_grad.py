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

Last, the card's backward routes: which one ``_backward_route`` picks from
the dtype and head dims, and each tensor-core route's rounding reproduced
in torch (3xTF32 products for f32; P and dS rounded to the 16-bit type for
bf16 and f16) against ``jax.grad`` within the card tests' ``BWD_TOL``
(1e-5 / 2e-2 / 2e-3 of the largest |gradient|).
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


# --------------------------------------------------------------------------
# the card's backward routes
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype,dh,dv,route", [
    (torch.float32, 64, 64, "tf32"),      # d's layer
    (torch.float32, 128, 128, "tf32"),
    (torch.float32, 48, 32, "tf32"),
    (torch.float32, 8, 8, "tf32"),
    (torch.float32, 136, 64, "simt"),     # a head above 128
    (torch.float32, 64, 256, "simt"),
    (torch.float32, 20, 20, "simt"),      # not multiples of 8
    (torch.float32, 64, 12, "simt"),
    (torch.bfloat16, 128, 128, "wgmma"),  # D's layer
    (torch.bfloat16, 40, 24, "wgmma"),
    (torch.float16, 8, 128, "wgmma"),
    (torch.bfloat16, 192, 128, "simt"),   # MLA's widths
    (torch.float16, 256, 256, "simt"),
    (torch.bfloat16, 20, 20, "simt"),
    (torch.float16, 64, 4, "simt"),
])
def test_backward_route_rules(dtype, dh, dv, route):
    assert FA._backward_route(dtype, dh, dv) == route
    assert route in FA.BWD_ROUTES
    assert f"flash_attention_bwd_{route}" in FA.launches


def _tf32_hi(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32, to nearest with ties away from zero (cvt.rna):
    the 13 low mantissa bits cleared after adding half of their weight."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """x as the tensor core reads an f32 register in TF32: the 13 low
    mantissa bits dropped."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b (f32) as the TF32 route forms it: each operand split into hi =
    tf32(x) and lo = x - hi, three products a_lo b_hi + a_hi b_lo + a_hi
    b_hi (each exact, summed in f32)."""
    ah, bh = _tf32_hi(a), _tf32_hi(b)
    al, bl = _tf32_trunc(a - ah), _tf32_trunc(b - bh)
    f = torch.float64
    return ((al.to(f) @ bh.to(f)) + (ah.to(f) @ bl.to(f))
            + (ah.to(f) @ bh.to(f))).float()


def _route_bwd(q, k, v, dout, causal, route):
    """The backward as a tensor-core route computes it, in torch: q, k, v,
    dout (B, H, S, d) in the inputs' dtype -> (dq, dk, dv) f32. The
    log-sum-exp and out come from the forward (f32 softmax); Delta =
    rowsum(dout o out) with out rounded to the inputs' type, as the forward
    writes it. ``"tf32"``: every product in 3xTF32. ``"wgmma"``: S and dP
    from the 16-bit inputs in f32, P and dS rounded to the 16-bit type for
    dV, dK and dQ."""
    dt = q.dtype
    sq, dh = q.shape[2], q.shape[3]
    scale = dh ** -0.5
    qf, kf, vf, dof = q.float(), k.float(), v.float(), dout.float()
    out, lse = FA.flash_attention_lse_plain(q, k, v, causal=causal)
    valid = FA._valid(sq, k.shape[2], causal, q.device)
    delta = (dof * out.float()).sum(-1, keepdim=True)
    if route == "tf32":
        mm = _mm3
    else:
        def mm(a, b):
            return a @ b
    s = mm(qf, kf.transpose(-1, -2))
    dp = mm(dof, vf.transpose(-1, -2))
    log2e = 1.4426950408889634
    p = torch.exp2(s * (scale * log2e) - lse[..., None] * log2e)
    p = p.masked_fill(~valid, 0.0)
    ds = p * (dp - delta)
    if route == "wgmma":
        p, ds = p.to(dt).float(), ds.to(dt).float()
    dv = mm(p.transpose(-1, -2), dof)
    dk = mm(ds.transpose(-1, -2), qf) * scale
    dq = mm(ds, kf) * scale
    return dq, dk, dv


BWD_TOL = {"float32": 1e-5, "bfloat16": 2e-2, "float16": 2e-3}
# dtype, route, causal, B, Sq, Skv, H, dh, dv
ROUTES = [
    ("float32", "tf32", True, 2, 24, 24, 2, 16, 16),
    ("float32", "tf32", False, 1, 13, 29, 2, 16, 8),
    ("float32", "tf32", True, 1, 21, 9, 2, 8, 16),      # Sq > Skv
    ("bfloat16", "wgmma", True, 2, 24, 24, 2, 16, 16),
    ("bfloat16", "wgmma", True, 1, 9, 21, 2, 16, 24),   # Sq < Skv, dv != dh
    ("float16", "wgmma", False, 1, 13, 29, 2, 8, 8),
]


@pytest.mark.parametrize("case", ROUTES, ids=[f"{c[1]}-{c[0]}-{c[3]}x{c[4]}x"
                                              f"{c[5]}" for c in ROUTES])
def test_route_rounding_matches_jax_grad(case):
    """Each tensor-core route's arithmetic, reproduced in torch from the
    same NumPy inputs, against ``jax.grad`` of JAX's
    ``blockwise_attention`` (f32 for the TF32 route, the 16-bit type for
    wgmma: JAX has no f16 path in the tests above, so f16 is held against
    JAX's f32 gradients of the f16-rounded inputs) within ``BWD_TOL`` of
    the largest |gradient|. Rows with no valid key get dq = 0."""
    dt, route, causal, b, sq, skv, h, dh, dv = case
    assert FA._backward_route(getattr(torch, dt), dh, dv) == route
    rng = np.random.default_rng(sq * 7 + skv + dv)
    q, k, v = (rng.normal(size=s).astype(np.float32) for s in
               ((b, sq, h, dh), (b, skv, h, dh), (b, skv, h, dv)))
    cot = rng.normal(size=(b, sq, h, dv)).astype(np.float32)
    tdt = getattr(torch, dt)
    # the inputs in the route's dtype, the same values on both sides
    q, k, v, cot = (torch.from_numpy(x).to(tdt).float().numpy()
                    for x in (q, k, v, cot))
    jdt = jnp.bfloat16 if dt == "bfloat16" else jnp.float32

    def jloss(q, k, v):
        out = JL.blockwise_attention(q, k, v, causal=causal, block_kv=8,
                                     q_offset=skv - sq)
        return jnp.sum(out.astype(jnp.float32) * cot)

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        *(jnp.asarray(x, jdt) for x in (q, k, v)))
    heads = [torch.from_numpy(x).to(tdt).transpose(1, 2) for x in (q, k, v)]
    dout = torch.from_numpy(cot).to(tdt).transpose(1, 2)
    got = _route_bwd(*heads, dout, causal, route)
    for x, want in zip(got, jg):
        x = x.transpose(1, 2).numpy()
        want = np.asarray(want, np.float32)
        assert np.isfinite(x).all() and x.shape == want.shape
        assert np.abs(x - want).max() <= BWD_TOL[dt] * np.abs(want).max()
    if causal and sq > skv:
        assert (got[0][:, :, : sq - skv] == 0).all()
