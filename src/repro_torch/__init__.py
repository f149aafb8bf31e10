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
kernel (``flash_attention.cu``) for long prefill; the distributed serve
step over a ``torch.distributed`` mesh (``serve.retrieval.make_serve_fn``
over ``launch.mesh``'s named meshes, the broker an all-gather in
``distributed``, K1 in every float32 segment scan) and the searcher
fleet's elastic plans (``train.elastic``); the LM training step
(``train``: AdamW, microbatching, remat, checkpoints, ``launch/train.py``)
with K3 and its backward kernel K3-bwd (``flash_attention_bwd.cu``) in
every layer; and the recsys family (``models/recsys.py``: AutoInt, DIN,
SASRec, xDeepFM, their configs, loss and training step) with the
retrieval_cand cell (``serve/recsys.py``: user tower, projection, K1 over
the candidate corpus); and the MoE and MLA LMs, deepseek-moe-16b and
deepseek-v2-lite-16b (``models/moe.py``, ``layers.mla_apply``), served
through ``ServeEngine`` with K3 in every prefill layer (MLA's q . k head
dim 192 with v's 128 included) and trained with K3-bwd; and the GNN
family, DimeNet (``models/dimenet.py``, ``data/sampler.py``), trained
with fixed-order gathers and segment sums (``models/segment.py``); and
the sharded cells (ROADMAP §1 item 10.4): the sharding rules
(``distributed/sharding_rules.py``: DTensor placements over a named
mesh), every family's cells with ``build_cell`` / ``smoke``
(``configs/families.py``) and the dry run on a fake world
(``launch/dryrun.py``); and the checkers (``analysis``, item 10.6: lock
discipline, race stress, the host-sync lint, the CUDA-launcher and scale
checks, the footprint model).  Every module of ``repro`` is ported.
"""
