"""The hand-written Hopper kernels and the backend contract.

* ``ref.py``             — plain PyTorch oracles, the correctness contract;
* ``backend.py``         — :class:`Backend`, the device rule, :class:`CorpusView`;
* ``l2_topk.py``         — the search kernels' wrappers and plain versions
  (``csrc/l2_topk.cu``);
* ``flash_attention.py`` — attention forward (tensor-core route
  ``csrc/flash_attention_wgmma.cu`` with ``csrc/wgmma.cuh``, SIMT route
  ``csrc/flash_attention.cu``) and decode (``csrc/flash_attention.cu``);
* ``embedding_bag.py``   — the bag sum/mean (``csrc/embedding_bag.cu``);
* ``_build.py``          — builds ``csrc/*.cu`` with nvcc and loads them (ctypes);
* ``ops.py``             — the dispatch layer the engine and users call.
"""
from repro_torch.kernels.backend import (NORM_EPS, QUANTIZE_MODES,  # noqa: F401
                                         Backend, CorpusView, as_corpus_view,
                                         corpus_rows, resolve_backend,
                                         resolve_device)
