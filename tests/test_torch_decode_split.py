"""The split-KV decode's host side and its rule, on the CPU.

The card's ``flash_decode`` cuts each (batch, head) row's keys into chunks
(:func:`repro_torch.kernels.flash_attention.decode_split`), gives each chunk
its own online softmax state, and combines a row's live chunks. Here:

* the split is a function of (S, B·H) alone that covers every key once;
* the split-and-combine rule, written in plain torch below, equals JAX's
  Pallas ``flash_decode`` (``backend="pallas-interpret"``) on the edges a
  split meets: length 0, a chunk with no valid key, S no multiple of the
  chunk;
* the lengths the kernels read: an int by value, an int32 (B,) tensor as it
  is, anything else converted and clamped.

The kernels themselves are held against the plain version on the card by
``tests/test_torch_cuda.py``.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops as tops

TOL = 2e-5  # the JAX kernel tests' f32 tolerance


@pytest.mark.parametrize("bh", [1, 8, 256, 4096])
@pytest.mark.parametrize("s", [1, 40, 511, 512, 513, 32768])
def test_decode_split_covers_every_key_once(s, bh):
    chunk, n = fa.decode_split(s, bh)
    assert chunk & (chunk - 1) == 0 and chunk >= fa.DECODE_CHUNK_MIN
    assert n == math.ceil(s / chunk) <= fa.DECODE_MAX_SPLITS
    hits = torch.zeros(s, dtype=torch.int64)
    for i in range(n):
        hits[i * chunk: min((i + 1) * chunk, s)] += 1
    assert (hits == 1).all()
    # the grid is as coarse as DECODE_BLOCKS allows: at most
    # DECODE_CHUNK_MAX keys a block, and 64 unless the grid already has
    # DECODE_BLOCKS blocks
    assert chunk <= fa.DECODE_CHUNK_MAX
    assert chunk == fa.DECODE_CHUNK_MIN or bh * n >= fa.DECODE_BLOCKS


def split_combine(q, k, v, lens, chunk):
    """The split-KV rule in plain torch (f32): chunk i of row (b, h) holds
    keys [i * chunk, min((i + 1) * chunk, S)); a chunk starting at or past
    clamp(length, 0, S) is dead. A live chunk's (m_i, l_i, acc_i) is the
    softmax state of its valid keys (masked scores -1e30, weight 0); the
    row's output is sum_i w_i acc_i / max(sum_i w_i l_i, 1e-30) with
    w_i = exp(m_i - max m) over the live chunks, 0 for a row with none."""
    b, h, dh = q.shape
    s = k.shape[1]
    qf, kf, vf = q.float(), k.float(), v.float()
    n_keys = lens.clamp(0, s)
    ms, ls, accs, live = [], [], [], []
    for lo in range(0, s, chunk):
        hi = min(lo + chunk, s)
        sc = torch.einsum("bhd,bshd->bhs", qf, kf[:, lo:hi]) / math.sqrt(dh)
        valid = (torch.arange(lo, hi)[None, None, :]
                 < n_keys[:, None, None])
        sc = sc.masked_fill(~valid, fa.NEG_INF)
        m = sc.amax(-1)
        p = torch.exp(sc - m[..., None]).masked_fill(~valid, 0.0)
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bhs,bshd->bhd", p, vf[:, lo:hi]))
        live.append((lo < n_keys)[:, None].expand(b, h))
    m, l, acc, live = (torch.stack(x) for x in (ms, ls, accs, live))
    m_max = m.masked_fill(~live, fa.NEG_INF).amax(0)
    w = torch.exp(m - m_max) * live
    return ((w[..., None] * acc).sum(0)
            / (w * l).sum(0).clamp(min=1e-30)[..., None])


@pytest.mark.parametrize("b,h,s,dh,dv,chunk,lengths", [
    # chunks [0,16) [16,32) [32,40): length 17 leaves the last chunk with
    # no valid key, length 5 the last two; S no multiple of the chunk
    (4, 2, 40, 16, 8, 16, (0, 17, 40, 5)),
    # the host's own chunk at these shapes (64): three chunks, the last of
    # 22 keys
    (3, 2, 150, 32, 32, None, (0, 64, 131)),
])
def test_split_combine_matches_pallas(b, h, s, dh, dv, chunk, lengths):
    chunk = chunk or fa.decode_split(s, b * h)[0]
    rng = np.random.default_rng(s + dh)
    q, k, v = (rng.normal(size=shape).astype(np.float32)
               for shape in ((b, h, dh), (b, s, h, dh), (b, s, h, dv)))
    lens = np.array(lengths, np.int32)
    want = np.asarray(jops.flash_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        length=jnp.asarray(lens), backend="pallas-interpret", block_k=32))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = split_combine(tq, tk, tv, torch.from_numpy(lens), chunk)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    assert (got[0] == 0).all()
    # and the port's decode op (its plain version on the CPU)
    np.testing.assert_allclose(
        tops.flash_decode(tq, tk, tv, length=torch.from_numpy(lens)).numpy(),
        want, atol=TOL, rtol=TOL)


def test_kernel_lengths_convert_only_what_needs_it():
    cpu = torch.device("cpu")
    assert fa._kernel_lengths(7, 3, 5, cpu).tolist() == [5, 5, 5]
    assert fa._kernel_lengths(np.int64(-2), 3, 5, cpu).tolist() == [0, 0, 0]
    lens = torch.tensor([0, 9, 3], dtype=torch.int32)
    assert fa._kernel_lengths(lens, 3, 5, cpu) is lens  # the kernels clamp
    got = fa._kernel_lengths(lens.long(), 3, 5, cpu)
    assert got.dtype == torch.int32 and got.tolist() == [0, 5, 3]
    got = fa._kernel_lengths(torch.tensor(4), 3, 5, cpu)
    assert got.dtype == torch.int32 and got.tolist() == [4, 4, 4]
