"""PyTorch + CUDA port of the bi-metric similarity-search library.

Laid out like the JAX package ``repro`` (module for module, name for name),
written in PyTorch idiom: plain functions on tensors, ``NamedTuple`` states,
an explicit ``device=`` argument, ``torch.Generator`` randomness, batch
dimensions written out, and host loops instead of ``lax.while_loop``.

Device rule: every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; with no CUDA device and no explicit ``"cpu"`` it raises.
On a CUDA tensor every scoring and merge call launches the hand-written
Hopper kernels of :mod:`repro_torch.kernels.l2_topk`; on a CPU tensor the
same wrappers run their plain PyTorch versions.

Float32 matrix products run in full float32: TF32 is switched off for
cuBLAS and cuDNN when this package is imported, because ``pairwise`` (robust
prune, the medoid, the brute-force ground truth) would otherwise keep only
about three decimal digits on the card.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
