"""LANNS on PyTorch and CUDA (NVIDIA Hopper).

The port of the JAX package ``repro``, module for module.  It imports
``torch`` and ``numpy`` only.  Entry points run on the CUDA device unless the
caller passes ``device="cpu"``; on the CPU every kernel wrapper runs its plain
PyTorch version.

Ported so far: the scan-engine main path (fit -> build -> query -> recall)
with the fused distance + top-k kernel (``kernels/csrc/distance_topk.cu``).
"""
