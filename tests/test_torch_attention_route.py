"""The attention wrapper's route, and the function the tensor-core route
computes, as far as the CPU can check them.

The CUDA kernels run only on the card (``test_torch_cuda.py``), but which
kernel a call takes is plain Python: :func:`flash_attention._attention_route`
picks the route from the dtype and head dims alone. At the shapes that probe
the tensor-core route's edges, the wrapper's CPU path (the plain version the
card's kernel is held to) equals the Pallas kernel in interpret mode.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops as tops

# (dh, dv, tensor cores for 16-bit inputs): every head width the repo's
# configurations define (sfr-mistral-7b and deepseek-coder-33b 128,
# bge-micro-like 64, DeepSeek-V3 192/128, the smoke configs' 16 and 8), a
# head padded by the copy (24), and widths the route refuses (no multiple of
# 8, wider than 256)
HEADS = [(128, 128, True), (64, 64, True), (192, 128, True), (16, 16, True),
         (8, 8, True), (24, 24, True), (256, 256, True), (128, 64, True),
         (20, 20, False), (64, 36, False), (4, 4, False), (264, 64, False),
         (128, 260, False), (33, 64, False)]


@pytest.mark.parametrize("dh,dv,tensor_cores", HEADS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_attention_route(dtype, dh, dv, tensor_cores):
    want = "wgmma" if tensor_cores and dtype != torch.float32 else "simt"
    assert fa._attention_route(dtype, dh, dv) == want
    # a pure function of its arguments
    assert fa._attention_route(dtype, dh, dv) == want


# B, H, Sq, Skv, dh, dv, causal, dtype: lengths that no tile divides,
# Sq > Skv under causal (empty rows), non-causal, dh != dv, heads of 192 and
# 256, heads the copy pads (24, 8), and more tiles than the card has SMs
# (4 * 8 heads * 5 query tiles), causal and not
EDGES = [
    (2, 3, 70, 70, 128, 128, True, "bfloat16"),
    (2, 1, 100, 37, 128, 128, True, "bfloat16"),
    (2, 1, 300, 37, 64, 64, True, "float16"),
    (1, 2, 100, 37, 64, 64, False, "bfloat16"),
    (1, 2, 200, 333, 128, 128, False, "float16"),
    (1, 2, 300, 300, 192, 128, True, "float16"),
    (1, 2, 300, 300, 256, 256, True, "bfloat16"),
    (1, 2, 150, 200, 256, 256, False, "float16"),
    (2, 2, 257, 257, 24, 24, True, "bfloat16"),
    (1, 2, 77, 77, 8, 8, True, "float16"),
    (4, 8, 600, 400, 64, 64, False, "bfloat16"),
    (4, 8, 600, 400, 64, 64, True, "float16"),
    (1, 1, 1, 1, 8, 8, True, "bfloat16"),
    (1, 2, 129, 128, 64, 64, True, "float16"),
]
#: both sides compute in f32 from the same 16-bit inputs and round once:
#: about one unit in the last place of the output type
TOL = {"bfloat16": 2e-2, "float16": 2e-3}


@pytest.mark.parametrize("b,h,sq,skv,dh,dv,causal,dtype", EDGES)
def test_tensor_core_edges_match_pallas(b, h, sq, skv, dh, dv, causal,
                                        dtype):
    assert fa._attention_route(getattr(torch, dtype), dh, dv) == "wgmma"
    rng = np.random.default_rng(sq * 7 + skv + dh)
    qkv = [rng.normal(size=s).astype(np.float32) for s in (
        (b, h, sq, dh), (b, h, skv, dh), (b, h, skv, dv))]
    jq, jk, jv = (jnp.asarray(a, getattr(jnp, dtype)) for a in qkv)
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in qkv)
    want = np.asarray(jops.flash_attention(
        jq, jk, jv, causal=causal, backend="pallas-interpret"), np.float32)
    got = tops.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == (b, h, sq, dv)
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL[dtype],
                               rtol=TOL[dtype])
    if causal and sq > skv:
        assert (got[:, :, : sq - skv] == 0).all()
