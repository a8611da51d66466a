"""Port kernel layer vs the JAX reference: gather→score, quantized views,
and the stable pool merge.

The same numpy inputs go through the JAX package (its ``ref`` oracle and its
Pallas kernels under ``pallas-interpret``) and through the port's wrappers,
which run their plain versions on CPU tensors. The kernels themselves are
held against these plain versions on the card by ``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import backend as jbackend
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.convert import corpus_view_from_numpy, tensor_from_numpy
from repro_torch.kernels import backend as tbackend
from repro_torch.kernels import ops as tops

METRICS = ["l2", "sqeuclidean", "ip", "cosine"]
CPU = "cpu"


def _inputs(seed, n=90, dim=32, b=3, k=14):
    rng = np.random.default_rng(seed)
    corpus = rng.normal(size=(n, dim)).astype(np.float32)
    corpus[5] = 0.0  # a zero row: cosine must be exactly 1.0
    qs = rng.normal(size=(b, dim)).astype(np.float32)
    ids = rng.integers(-1, n, size=(b, k)).astype(np.int32)
    ids[:, 0] = 5
    ids[0, 1] = -1
    return corpus, qs, ids


def _t(a):
    return tensor_from_numpy(a, CPU)


def _jview_np(view):
    return [None if f is None else np.asarray(f) for f in view]


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("form", ["reduce", "matmul", "quant"])
def test_gather_score_matches_jax(metric, form):
    """Port plain versions == JAX ref and pallas-interpret, 4 metrics × 3
    forms; padding lanes +inf, a zero row scores cosine 1.0 exactly."""
    corpus, qs, ids = _inputs(seed=len(metric) + len(form))
    jq, jids = jnp.asarray(qs), jnp.asarray(ids)
    if form == "quant":
        jview = jbackend.as_corpus_view(jnp.asarray(corpus), quantize="int8")
        tview = corpus_view_from_numpy(*_jview_np(jview), device=CPU)
        d_ref = np.asarray(jref.gather_score_quant_ref(
            jview.rows, jview.scales, jview.zero_points, jq, jids, metric))
        jsrc, tsrc = jview, tview
        tbe = "ref"
    else:
        d_ref = np.asarray(jref.gather_score_ref(jnp.asarray(corpus), jq,
                                                 jids, metric))
        jsrc, tsrc = jnp.asarray(corpus), _t(corpus)
        tbe = "matmul" if form == "matmul" else "ref"
    d_pl = np.asarray(jops.gather_score(jsrc, jq, jids, metric=metric,
                                        backend="pallas-interpret"))
    d_t = tops.gather_score(tsrc, _t(qs), _t(ids), metric=metric,
                            backend=tbe).numpy()
    fin = np.isfinite(d_ref)
    assert (np.isinf(d_t) == ~fin).all()
    tol = 1e-5 if form != "matmul" else 1e-4
    np.testing.assert_allclose(d_t[fin], d_ref[fin], rtol=tol, atol=tol)
    np.testing.assert_allclose(d_t[fin], d_pl[fin], rtol=1e-4, atol=1e-4)
    if metric == "cosine":
        assert (d_t[:, 0] == 1.0).all()
    if form == "quant":  # the norm-cache form over the same codes
        d_mm = tops.gather_score(tsrc, _t(qs), _t(ids), metric=metric,
                                 backend="matmul").numpy()
        np.testing.assert_allclose(d_mm[fin], d_pl[fin], rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("mode", ["int8", "fp8", "fp8_e5m2"])
def test_quantized_view_matches_jax(mode):
    """Codes, scales and zero points equal JAX's as_corpus_view bit for
    bit; norms over the dequantized rows agree to f32 rounding."""
    rng = np.random.default_rng(7)
    corpus = (rng.normal(size=(64, 40)) * 3.0).astype(np.float32)
    corpus[3] = 0.0
    jview = jbackend.as_corpus_view(jnp.asarray(corpus), quantize=mode)
    tview = tbackend.as_corpus_view(_t(corpus), quantize=mode)
    assert tview.quantize == mode
    jrows = _t(np.asarray(jview.rows))
    assert tview.rows.dtype == jrows.dtype
    assert torch.equal(tview.rows.view(torch.uint8), jrows.view(torch.uint8))
    np.testing.assert_array_equal(tview.scales.numpy(),
                                  np.asarray(jview.scales))
    if mode == "int8":
        np.testing.assert_array_equal(tview.zero_points.numpy(),
                                      np.asarray(jview.zero_points))
    else:
        assert tview.zero_points is None and jview.zero_points is None
    np.testing.assert_allclose(tview.sq_norms.numpy(),
                               np.asarray(jview.sq_norms), rtol=1e-6)
    np.testing.assert_allclose(tview.inv_norms.numpy(),
                               np.asarray(jview.inv_norms), rtol=1e-6)
    assert tview.sq_norms[3] == 0.0
    assert tview.bytes_per_row == jview.bytes_per_row
    with pytest.raises(ValueError):
        tbackend.as_corpus_view(tview, quantize="fp8" if mode == "int8"
                                else "int8")


def test_raw_view_and_backend_knob():
    corpus, _, _ = _inputs(seed=3)
    jview = jbackend.as_corpus_view(jnp.asarray(corpus))
    tview = tbackend.as_corpus_view(_t(corpus))
    np.testing.assert_allclose(tview.sq_norms.numpy(),
                               np.asarray(jview.sq_norms), rtol=1e-6)
    assert tview.quantize is None and tview.rows.dtype == torch.float32
    assert tbackend.resolve_backend(None) == tbackend.Backend("ref")
    assert tbackend.resolve_backend("matmul", quantize="int8").quantize == "int8"
    for bad in ("auto", "xla_matmul", "pallas"):
        with pytest.raises(ValueError):
            tbackend.resolve_backend(bad)
    with pytest.raises(ValueError):
        tbackend.resolve_backend(tbackend.Backend("ref", "int8"),
                                 quantize="fp8")


def _merge_inputs(seed, b=4, P=16, K=24):
    rng = np.random.default_rng(seed)
    pi = rng.integers(0, 500, (b, P)).astype(np.int32)
    pd = np.sort(rng.integers(0, 6, (b, P)).astype(np.float32), 1)  # ties
    pd[:, -3:] = np.inf
    pi[:, -3:] = -1
    pf = rng.random((b, P)) < 0.5
    ci = rng.integers(-1, 500, (b, K)).astype(np.int32)
    cd = rng.integers(0, 6, (b, K)).astype(np.float32)
    cd[ci < 0] = np.inf
    cd[1] = np.inf  # an all-masked wave on row 1
    ci[1] = -1
    return pi, pd, pf, ci, cd


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_pool_batch_matches_ref(seed):
    """Port merge == JAX stable merge exactly (ties, +inf pads, payload);
    the all-masked row is an exact no-op; the Pallas network agrees on
    the distances."""
    pi, pd, pf, ci, cd = _merge_inputs(seed)
    ji, jd, jf = (np.asarray(a) for a in jref.merge_pool_batch_ref(
        *(jnp.asarray(a) for a in (pi, pd, pf, ci, cd))))
    ti, td, tf = tops.merge_pool_batch(*(_t(a) for a in (pi, pd, pf, ci, cd)))
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_array_equal(td.numpy(), jd)
    np.testing.assert_array_equal(tf.numpy(), jf)
    np.testing.assert_array_equal(ti.numpy()[1], pi[1])
    np.testing.assert_array_equal(tf.numpy()[1], pf[1])
    # the JAX engine's top_k route is the same stable contract
    xi, _, _ = jops.merge_pool_batch(
        *(jnp.asarray(a) for a in (pi, pd, pf, ci, cd)))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(xi))
    _, pld, _ = jops.merge_pool_batch(
        *(jnp.asarray(a) for a in (pi, pd, pf, ci, cd)),
        backend="pallas-interpret")
    np.testing.assert_array_equal(td.numpy(), np.asarray(pld))
    bi, bd = tops.beam_merge_topk(*(_t(a) for a in (pi, pd, ci, cd)))
    ri, rd = jref.beam_merge_topk_ref(*(jnp.asarray(a)
                                        for a in (pi, pd, ci, cd)))
    np.testing.assert_array_equal(bi.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(bd.numpy(), np.asarray(rd))


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_merge_keeps_half_dtype(dtype):
    pi, pd, pf, ci, cd = _merge_inputs(5)
    tdt = getattr(torch, dtype)
    td = _t(pd).to(tdt)
    tcd = _t(cd).to(tdt)
    ti, od, _ = tops.merge_pool_batch(_t(pi), td, _t(pf), _t(ci), tcd)
    assert od.dtype == tdt
    jd = jnp.asarray(pd).astype(getattr(jnp, dtype))
    jcd = jnp.asarray(cd).astype(getattr(jnp, dtype))
    ji, jdd, _ = jref.merge_pool_batch_ref(jnp.asarray(pi), jd,
                                           jnp.asarray(pf), jnp.asarray(ci),
                                           jcd)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(od.float().numpy(),
                                  np.asarray(jdd).astype(np.float32))


def test_sorted_set_ops_match_jax():
    rng = np.random.default_rng(11)
    sets = np.sort(rng.integers(0, 50, (3, 12)).astype(np.int32), 1)
    sets[:, -4:] = tops.SET_PAD
    new = rng.integers(-1, 50, (3, 5)).astype(np.int32)
    new[new < 0] = tops.SET_PAD
    probe = rng.integers(-1, 50, (3, 9)).astype(np.int32)
    assert tops.SET_PAD == int(jops.SET_PAD)
    np.testing.assert_array_equal(
        tops.sorted_set_merge(_t(sets), _t(new)).numpy(),
        np.asarray(jops.sorted_set_merge(jnp.asarray(sets), jnp.asarray(new))))
    np.testing.assert_array_equal(
        tops.sorted_set_lookup(_t(sets), _t(probe)).numpy(),
        np.asarray(jops.sorted_set_lookup(jnp.asarray(sets),
                                          jnp.asarray(probe))))
    np.testing.assert_array_equal(
        tops.sorted_set_unique_count(_t(sets)).numpy(),
        np.asarray(jops.sorted_set_unique_count(jnp.asarray(sets))))


def test_build_cache_key_covers_shared_headers(tmp_path, monkeypatch):
    from repro_torch.kernels import _build

    src = tmp_path / "k.cu"
    src.write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "build"))
    before = _build._target(src)
    assert _build._target(src) == before
    (tmp_path / "common.cuh").write_text("// two\n")
    assert _build._target(src) != before


def test_kernel_sources_include_only_shipped_headers():
    import re

    from repro_torch.kernels import _build

    for src in _build.CSRC.glob("*.cu"):
        for name in re.findall(r'#include "([^"]+)"', src.read_text()):
            assert (_build.CSRC / name).is_file(), (src.name, name)
