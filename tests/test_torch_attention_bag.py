"""Port attention, decode and bag ops vs the JAX reference.

The same numpy inputs go through the JAX package and through the port, whose
wrappers run their plain versions on CPU tensors:

* the sweep shapes of ``tests/test_kernels.py`` hold the port's ``ref.*``
  and ``ops.*`` against JAX's ``ref.*``;
* one tiny case per kernel holds ``ops.*`` against the Pallas kernel under
  ``pallas-interpret``, on the edges the oracle does not share: empty
  causal rows and decode length 0 give 0 (the oracles give NaN, on both
  sides), tiles that do not divide the lengths, an all-pad bag.

The kernels themselves are held against these plain versions on the card by
``test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.convert import tensor_from_numpy
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

CPU = "cpu"
# one XLA compile per shape instead of one per eager op
J_ATTN = jax.jit(jref.flash_attention_ref, static_argnames=("causal",))
J_DECODE = jax.jit(jref.flash_decode_ref)
J_BAG = jax.jit(jref.embedding_bag_ref, static_argnames=("mode",))
TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # the JAX kernel tests' own
BAG_TOL = 1e-5


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _pair(a, dtype="float32"):
    """The same values as a JAX array and a CPU tensor (bf16 rounds alike)."""
    t = tensor_from_numpy(a, CPU)
    if dtype == "bfloat16":
        return jnp.asarray(a, jnp.bfloat16), t.to(torch.bfloat16)
    return jnp.asarray(a), t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("b,h,sq,skv,dh,dv,causal,dtype", [
    (2, 4, 128, 128, 64, 64, True, "float32"),
    (1, 2, 96, 96, 32, 32, True, "float32"),      # non-multiple of a tile
    (2, 2, 64, 256, 32, 32, False, "float32"),    # cross attention
    (1, 1, 128, 128, 128, 128, True, "bfloat16"),
    (1, 2, 33, 65, 16, 16, True, "float32"),      # odd sizes
    (1, 2, 64, 64, 48, 32, True, "float32"),      # MLA: dv != dh
])
def test_flash_attention_matches_jax_ref(b, h, sq, skv, dh, dv, causal, dtype):
    rng = np.random.default_rng(sq + skv + dh)
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair(_normal(rng, *s), dtype)
        for s in ((b, h, sq, dh), (b, h, skv, dh), (b, h, skv, dv)))
    want = J_ATTN(jq, jk, jv, causal=causal)
    got_ref = tref.flash_attention_ref(tq, tk, tv, causal=causal)
    got = tops.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == (b, h, sq, dv)
    _close(got_ref, want, TOL[dtype])
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("b,h,s,dh", [(2, 4, 256, 64), (1, 2, 100, 32),
                                      (3, 1, 512, 128)])
def test_flash_decode_matches_jax_ref(b, h, s, dh):
    rng = np.random.default_rng(s + dh)
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair(_normal(rng, *shape))
        for shape in ((b, h, dh), (b, s, h, dh), (b, s, h, dh)))
    lengths = rng.integers(1, s + 1, size=b).astype(np.int32)
    want = J_DECODE(jq, jk, jv, length=jnp.asarray(lengths))
    tl = torch.from_numpy(lengths)
    _close(tref.flash_decode_ref(tq, tk, tv, length=tl), want, TOL["float32"])
    _close(tops.flash_decode(tq, tk, tv, length=tl), want, TOL["float32"])


@pytest.mark.parametrize("v,d,b,l,mode", [
    (200, 32, 8, 10, "sum"), (200, 32, 8, 10, "mean"),
    (64, 128, 4, 5, "sum"), (1000, 16, 16, 30, "mean"),
])
def test_embedding_bag_matches_jax_ref(v, d, b, l, mode):
    rng = np.random.default_rng(v + d)
    jt, tt = _pair(_normal(rng, v, d))
    idx = rng.integers(-1, v, size=(b, l)).astype(np.int32)
    want = J_BAG(jt, jnp.asarray(idx), mode=mode)
    ti = torch.from_numpy(idx)
    _close(tref.embedding_bag_ref(tt, ti, mode=mode), want, BAG_TOL)
    _close(tops.embedding_bag(tt, ti, mode=mode), want, BAG_TOL)


def test_flash_attention_edges_match_pallas():
    """Sq > Skv causal: the first Sq - Skv rows have no key, 0 in the port
    and in the Pallas kernel, NaN in both oracles. 16-wide tiles divide
    neither length, and dv != dh."""
    rng = np.random.default_rng(7)
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair(_normal(rng, *s)) for s in ((1, 1, 40, 16), (1, 1, 24, 16),
                                          (1, 1, 24, 8)))
    want = jops.flash_attention(jq, jk, jv, causal=True,
                                backend="pallas-interpret", block_q=16,
                                block_k=16)
    got = tops.flash_attention(tq, tk, tv, causal=True)
    _close(got, want, TOL["float32"])
    assert (got[:, :, :16] == 0).all() and not (got[:, :, 16:] == 0).all()
    oracle = tref.flash_attention_ref(tq, tk, tv, causal=True).numpy()
    np.testing.assert_array_equal(
        np.isnan(oracle), np.isnan(np.asarray(J_ATTN(
            jq, jk, jv, causal=True))))
    assert np.isnan(oracle[:, :, :16]).all()
    _close(oracle[:, :, 16:], got[:, :, 16:], TOL["float32"])


def test_flash_decode_edges_match_pallas():
    """Lengths 0 and 17 with S = 40 over 32-key tiles: the port equals the
    Pallas kernel, a length-0 row is 0 (NaN in both oracles). Past S the
    port clamps, as the oracle does."""
    rng = np.random.default_rng(8)
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair(_normal(rng, *s)) for s in ((2, 1, 16), (2, 40, 1, 16),
                                          (2, 40, 1, 8)))
    lengths = np.array([0, 17], np.int32)
    want = jops.flash_decode(jq, jk, jv, length=jnp.asarray(lengths),
                             backend="pallas-interpret", block_k=32)
    got = tops.flash_decode(tq, tk, tv, length=torch.from_numpy(lengths))
    _close(got, want, TOL["float32"])
    assert (got[0] == 0).all()
    oracle = tref.flash_decode_ref(tq, tk, tv, length=torch.from_numpy(lengths))
    assert torch.isnan(oracle[0]).all()
    assert np.isnan(np.asarray(J_DECODE(
        jq, jk, jv, length=jnp.asarray(lengths)))[0]).all()
    _close(oracle[1], got[1], TOL["float32"])
    # past S: every key is valid, in the port and in the oracle
    _close(tops.flash_decode(tq, tk, tv, length=45),
           J_DECODE(jq, jk, jv, length=45), TOL["float32"])


def test_embedding_bag_edges_match_pallas():
    """An all-pad bag (the mean divides by max(count, 1)), a bag of one id
    and repeated ids."""
    rng = np.random.default_rng(9)
    jt, tt = _pair(_normal(rng, 30, 5))
    idx = np.array([[-1, -1, -1, -1], [-1, 4, -1, -1], [9, 9, 9, 2]],
                   np.int32)
    want = jops.embedding_bag(jt, jnp.asarray(idx), mode="mean",
                              backend="pallas-interpret")
    got = tops.embedding_bag(tt, torch.from_numpy(idx), mode="mean")
    _close(got, want, BAG_TOL)
    assert (got[0] == 0).all()
    torch.testing.assert_close(got[1], tt[4], rtol=0, atol=0)


def test_port_ops_validate_and_cast():
    """bf16 in, bf16 out; an int length equals a (B,) length; what the ops
    do not take raises on the CPU as on the card."""
    rng = np.random.default_rng(10)
    q, k, v = (tensor_from_numpy(_normal(rng, *s), CPU)
               for s in ((1, 2, 8, 4), (1, 2, 8, 4), (1, 2, 8, 4)))
    assert tops.flash_attention(q.bfloat16(), k.bfloat16(),
                                v.bfloat16()).dtype == torch.bfloat16
    with pytest.raises(ValueError):
        tops.flash_attention(q, k.bfloat16(), v)
    strided = k.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError, match="not contiguous"):
        tops.flash_attention(q, strided, v)
    dq, dk = q[:, :, 0].contiguous(), k.transpose(1, 2).contiguous()
    torch.testing.assert_close(
        tops.flash_decode(dq, dk, dk, length=5),
        tops.flash_decode(dq, dk, dk, length=torch.tensor([5])))
    with pytest.raises(ValueError):
        tops.embedding_bag(q[0, 0], torch.zeros((2, 3), dtype=torch.int64),
                           mode="max")
    assert tops.embedding_bag(q[0, 0].half(), torch.zeros(
        (2, 3), dtype=torch.int64)).dtype == torch.float16
    with pytest.raises(ValueError, match="V >= 1"):
        tops.embedding_bag(torch.zeros((0, 4)), -torch.ones((2, 3)).long())


def test_card_routes_refuse_autograd(monkeypatch):
    """``flash_decode`` and ``embedding_bag`` fill their outputs on the card
    through ctypes, out of autograd's sight, and have no backward kernel:
    their guard raises while grad is on and an input requires grad, and
    passes under ``inference_mode`` / ``no_grad`` or with no such input.
    ``flash_attention`` has its backward kernel: its card route records a
    ``torch.autograd.Function`` (run here with the card's forward and
    backward replaced by the plain versions) whose gradients are the plain
    version's. The CPU route, the plain version, still differentiates."""
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels.l2_topk import _refuse_grad

    x = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="flash_decode: .*no backward"):
        _refuse_grad("flash_decode", torch.ones(3), x)
    for mode in (torch.inference_mode, torch.no_grad):
        with mode():
            _refuse_grad("flash_decode", x)
    _refuse_grad("embedding_bag", x.detach(), torch.ones(2))
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(_normal(rng, 1, 2, 5, 8)).requires_grad_()
               for _ in range(3))
    tops.flash_attention(q, k, v).sum().backward()
    # the autograd forward also hands the card a log-sum-exp buffer, and
    # its backward reads it back
    monkeypatch.setattr(tfa, "_forward_card", lambda q, k, v, c, s, lse=None:
                        tfa.flash_attention_plain(q, k, v, causal=c,
                                                  sm_scale=s))
    monkeypatch.setattr(tfa, "_backward_card",
                        lambda q, k, v, o, do, c, s, lse=None:
                        tfa.flash_attention_bwd_plain(q, k, v, o, do, causal=c,
                                                      sm_scale=s))
    qc, kc, vc = (t.detach().clone().requires_grad_() for t in (q, k, v))
    out = tfa._FlashAttention.apply(qc, kc, vc, True, 8 ** -0.5)
    assert out.grad_fn is not None
    out.sum().backward()
    for got, want in zip((qc.grad, kc.grad, vc.grad), (q.grad, k.grad, v.grad)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    qd, kd, vd = (torch.from_numpy(_normal(rng, *s)).requires_grad_()
                  for s in ((2, 2, 8), (2, 5, 2, 8), (2, 5, 2, 8)))
    tops.flash_decode(qd, kd, vd, length=3).sum().backward()
    assert kd.grad[:, 3:].eq(0).all() and vd.grad[:, :3].ne(0).any()
    table = torch.from_numpy(_normal(rng, 6, 4)).requires_grad_()
    tops.embedding_bag(table, torch.tensor([[0, 2, -1]])).sum().backward()
    assert torch.isfinite(q.grad).all() and table.grad[2].eq(1).all()
