"""Kernel-backend selection, the device rule and the corpus-norm cache.

Backends (one knob, as in the JAX package, with the TPU-specific names
folded away):

* ``"ref"`` (default) — scores waves in gather-then-reduce form, the
  correctness contract every bit-exactness guarantee is stated against;
* ``"matmul"`` — scores in norm-cache form ``‖x‖² − 2·⟨x, q⟩ + ‖q‖²`` over a
  :class:`CorpusView` (the JAX package's ``xla_matmul`` and ``pallas`` both
  map to it). Same math up to fp association.

The backend picks the *form* of the score, never the device: on a CUDA
tensor both forms launch the hand-written kernels of
:mod:`repro_torch.kernels.l2_topk`, on a CPU tensor both run the plain
PyTorch versions beside them. There is no ``"auto"``: the device is the
caller's ``device=`` (see :func:`resolve_device`).

Quantized residency (``quantize="int8" | "fp8" | "fp8_e5m2"``): rows are
stored as int8 codes with a per-row affine scale/zero point, or as fp8 codes
with a per-row scale; norms are computed over the dequantized rows, so every
form scores exactly ``ref.dequant_rows_ref`` of the codes. Views are
immutable snapshots; requantizing a view raises.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import ref as _ref

BACKEND_NAMES = ("ref", "matmul")

QUANTIZE_MODES = ("int8", "fp8", "fp8_e5m2")

_FP8_DTYPES = {"fp8": torch.float8_e4m3fn, "fp8_e5m2": torch.float8_e5m2}

#: epsilon under the cosine rsqrt: a zero row has ``‖x‖² = 0`` and a finite
#: inverse norm, so its cosine distance is exactly 1.0 in every form
NORM_EPS = 1e-12


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless told otherwise.

    ``None`` means the card; without a visible CUDA device that raises
    instead of running on the CPU behind the caller's back. Pass
    ``device="cpu"`` to run the plain versions on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    return dev


def as_tensor(x, device: torch.device, dtype: torch.dtype | None = None):
    """A numpy array or tensor on ``device`` (no copy when already there)."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.require(x, requirements=["C", "W"]))
    elif not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x)
    return x.to(device=device, dtype=dtype)


@dataclasses.dataclass(frozen=True)
class Backend:
    """Resolved scoring choice: the form (``name``) and the residency
    (``quantize``, None = score whatever the view holds)."""

    name: str = "ref"
    quantize: str | None = None

    def __post_init__(self):
        if self.name not in BACKEND_NAMES:
            raise ValueError(
                f"backend must be one of {BACKEND_NAMES}, got {self.name!r}")
        if self.quantize is not None and self.quantize not in QUANTIZE_MODES:
            raise ValueError(
                f"quantize must be None or one of {QUANTIZE_MODES}, "
                f"got {self.quantize!r}")

    @property
    def matmul(self) -> bool:
        """Score in norm-cache form over a :class:`CorpusView`?"""
        return self.name == "matmul"


REF = Backend("ref")


def resolve_backend(
    backend: str | Backend | None = None,
    *,
    quantize: str | None = None,
    _caller: str = "repro_torch.kernels",
) -> Backend:
    """Normalize the backend knob to a :class:`Backend`.

    ``quantize`` rides along onto the result; a Backend that already carries
    a different mode raises.
    """
    if backend is None:
        return Backend("ref", quantize=quantize)
    if isinstance(backend, Backend):
        if quantize is not None and backend.quantize not in (None, quantize):
            raise ValueError(
                f"{_caller}: quantize={quantize!r} conflicts with "
                f"backend.quantize={backend.quantize!r}")
        if quantize is not None and backend.quantize is None:
            return dataclasses.replace(backend, quantize=quantize)
        return backend
    return Backend(backend, quantize=quantize)


class CorpusView(NamedTuple):
    """Immutable corpus snapshot + per-row norm cache.

    ``rows`` keeps its dtype (bf16/f16 are not upcast); ``sq_norms`` is
    ``‖x‖²`` and ``inv_norms`` ``1/√(‖x‖² + NORM_EPS)``, both f32. With
    quantized residency ``rows`` holds int8/fp8 codes, ``scales`` (and for
    int8 ``zero_points``) the per-row dequant parameters, and the norms
    describe the dequantized rows.
    """

    rows: torch.Tensor  # (N, dim)
    sq_norms: torch.Tensor  # (N,) f32
    inv_norms: torch.Tensor  # (N,) f32
    scales: torch.Tensor | None = None  # (N,) f32
    zero_points: torch.Tensor | None = None  # (N,) f32, int8 only

    @property
    def n(self) -> int:
        return self.rows.shape[0]

    @property
    def dim(self) -> int:
        return self.rows.shape[1]

    @property
    def quantize(self) -> str | None:
        if self.scales is None:
            return None
        if self.rows.dtype == torch.int8:
            return "int8"
        for mode, dt in _FP8_DTYPES.items():
            if self.rows.dtype == dt:
                return mode
        raise ValueError(
            f"quantized view with unrecognized rows dtype {self.rows.dtype}")

    @property
    def bytes_per_row(self) -> int:
        per = self.rows.element_size() * self.dim
        per += self.sq_norms.element_size() + self.inv_norms.element_size()
        if self.scales is not None:
            per += self.scales.element_size()
        if self.zero_points is not None:
            per += self.zero_points.element_size()
        return per


def _quantize_rows_int8(rows_f32: torch.Tensor):
    """Per-row affine int8: q = clip(round(x/s) + z), dequant (q - z)·s."""
    mn = rows_f32.amin(dim=-1)
    mx = rows_f32.amax(dim=-1)
    scale = (mx - mn) / 255.0
    scale = torch.where(scale > 0.0, scale, torch.ones_like(scale))
    zp = torch.round(-128.0 - mn / scale)
    q = torch.clamp(torch.round(rows_f32 / scale[:, None]) + zp[:, None],
                    -128.0, 127.0).to(torch.int8)
    return q, scale, zp


def _quantize_rows_fp8(rows_f32: torch.Tensor, dtype: torch.dtype):
    """Per-row symmetric fp8: q = (x/s) in fp8, dequant q·s."""
    fmax = float(torch.finfo(dtype).max)
    amax = rows_f32.abs().amax(dim=-1)
    scale = torch.where(amax > 0.0, amax / fmax, torch.ones_like(amax))
    q = (rows_f32 / scale[:, None]).to(dtype)
    return q, scale


def _norms(rows_f32: torch.Tensor):
    sq = (rows_f32 * rows_f32).sum(dim=-1)
    return sq, torch.rsqrt(sq + NORM_EPS)


def as_corpus_view(corpus: torch.Tensor | CorpusView,
                   quantize: str | None = None) -> CorpusView:
    """Build (or pass through) the norm cache for a corpus, on its device.

    A :class:`CorpusView` is returned unchanged; one whose residency differs
    from ``quantize`` raises (views are never requantized).
    """
    if isinstance(corpus, CorpusView):
        if quantize is not None and corpus.quantize != quantize:
            raise ValueError(
                f"as_corpus_view(quantize={quantize!r}) got a prebuilt view "
                f"with quantize={corpus.quantize!r}; views are immutable "
                "snapshots — build a new view from the original corpus")
        return corpus
    if quantize is None:
        sq, inv = _norms(corpus.float())
        return CorpusView(rows=corpus, sq_norms=sq, inv_norms=inv)
    if quantize not in QUANTIZE_MODES:
        raise ValueError(
            f"quantize must be None or one of {QUANTIZE_MODES}, "
            f"got {quantize!r}")
    rows_f32 = corpus.float()
    if quantize == "int8":
        q, scale, zp = _quantize_rows_int8(rows_f32)
    else:
        q, scale = _quantize_rows_fp8(rows_f32, _FP8_DTYPES[quantize])
        zp = None
    sq, inv = _norms(_ref.dequant_rows_ref(q, scale, zp))
    return CorpusView(rows=q, sq_norms=sq, inv_norms=inv, scales=scale,
                      zero_points=zp)


def corpus_rows(corpus: torch.Tensor | CorpusView) -> torch.Tensor:
    """The raw (N, dim) rows of either corpus form."""
    return corpus.rows if isinstance(corpus, CorpusView) else corpus
