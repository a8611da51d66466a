"""Kernels of the search hot path and the backend contract.

* ``ref.py``      — plain PyTorch oracles, the correctness contract;
* ``backend.py``  — :class:`Backend`, the device rule, :class:`CorpusView`;
* ``l2_topk.py``  — the Hopper kernels' wrappers and plain versions;
* ``_build.py``   — builds ``csrc/*.cu`` with nvcc and loads them (ctypes);
* ``ops.py``      — the dispatch layer the engine calls.
"""
from repro_torch.kernels.backend import (NORM_EPS, QUANTIZE_MODES,  # noqa: F401
                                         Backend, CorpusView, as_corpus_view,
                                         corpus_rows, resolve_backend,
                                         resolve_device)
