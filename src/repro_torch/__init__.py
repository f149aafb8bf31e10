"""LANNS on PyTorch and CUDA (NVIDIA Hopper).

The port of the JAX package ``repro``, module for module.  It imports
``torch`` and ``numpy`` only.  Entry points run on the CUDA device unless the
caller passes ``device="cpu"``; on the CPU every kernel wrapper runs its plain
PyTorch version.

Ported so far: the main path (fit -> build -> query -> recall) with both
engines: HNSW (``core/hnsw.py``: the numpy wavefront builder and a batched
torch beam, fp32 and int8) and the scan, fp32 with the fused distance +
top-k kernel (``kernels/csrc/distance_topk.cu``, also the exact ground
truth) and int8 two-stage with its int8 twin (``distance_topk_q8.cu``);
persistence and resumable builds (``LannsIndex.save`` / ``load`` /
``build(resume_dir=)``, artifacts byte-compatible with the reference's);
online serving (``serve``: ``AnnFrontend`` / ``AsyncAnnFrontend``, the SLO
controller, the load generator, ``launch/serve.py``) with telemetry
(``obs``) and the retrace sentinel (``analysis``); and the LM serving path
(dense GQA transformer, ``serve.ServeEngine``) with the flash-attention
kernel (``flash_attention.cu``) for long prefill.

Not ported: the benchmark twins, elastic serving over saved artifacts
(``train/elastic.py``), on-mesh sharded serving, the models beyond the
dense LMs, and the static analyzers (ROADMAP "Modules to port").
"""
