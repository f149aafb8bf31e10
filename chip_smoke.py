#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) end to end on one GPU.

    python3 chip_smoke.py

Phases, each printed as JSON records; any failure exits non-zero:

1. card: ``nvidia-smi`` name and power limit, and the kernel build (one
   nvcc per translation unit, all started together, from the sources in
   this checkout; K1's and K2's k_pad instances are units of their own).
2. K1 vs plain: ``ops.distance_topk`` on CUDA tensors against
   ``ref.distance_topk_blocked`` on the same tensors, for l2/ip/cos,
   k in {10, 100, 200, 400} (k_pad 128/256/512), D in {50, 128, 960, 2048},
   ragged B and N, n_valid < N, k > N and N == 0; the batched scan's tile
   edges (B = 127 and 129 queries, N = 63 and 65 rows, a corpus chunk that
   ends one row past or short of a whole chunk, at each k_pad) and D in
   {1, 7, 9, 33}; the batch edges (B in {1, 2, B_SMALL, B_SMALL + 1, 63,
   65}: the small-batch scan, its threshold, a warpgroup's 64 queries) at
   D in {7, 18, 50, 128, 512}, n_valid < N, each k_pad.  rtol = atol =
   3e-4; ids equal up to one swap per row between near-equal distances at
   the k-th place; every case launched twice, bit-equal.
2b. K2 vs plain: ``ops.distance_topk_q8`` (int8 codes on the card) against
   ``ref.distance_topk_q8_blocked`` on the same tensors, for l2/ip/cos,
   k in {10, 38, 120, 228, 400}, D in {50, 128, 512, 960, 2048}, ragged B
   and N, n_valid < N, k > N and N == 0; phase 2's tile edges and D in
   {31, 33} codes, and phase 2's batch edges.  Scores BIT-EQUAL; ids equal
   up to swaps between equal scores at the k-th place, and every returned
   id carries its own plain score; every case launched twice, bit-equal.  The torch query codes are bit-equal to the
   numpy codec's.
3. paper protocol: SIFT1M shape (paper Table 1), 2 shards x 4 RH segments,
   alpha 0.15, scan engine, l2, topk 100, batches of 1024: build seconds,
   QPS, recall@{1,10,100} against brute force on the card, and the id-set
   overlap with the same index built on the CPU (plain path).
3b. paper protocol, int8 two-stage scan (``quantized="q8"``,
   rerank_factor 2, exact re-rank on the card) on phase 3's data: build
   seconds (encode included), QPS, recall@{1,10,100}, recall relative to
   phase 3's fp32 ids (>= 0.99), K2 launches per batch, the route / stage-1
   / rerank / merge split, and the overlap with the CPU q8 index (>= 0.999).
3c. paper protocol, HNSW (``engine="hnsw"`` at LannsConfig's defaults: M 16,
   ef_construction 100, ef_search 100) on phase 3's data: first the build
   pool's check (``workers=8`` and ``workers=0`` give equal graphs on the
   first 16,000 rows, after CUDA is initialized), then the 1M build with
   ``workers=min(8, cores)``: build seconds and per-partition summary,
   resident device bytes (vectors + adj0 + upper_adj + keys), QPS, p50/p99
   batch latency (CUDA events), the route / beam / merge split, beam
   iterations, host syncs and lanes per batch, recall@{1,10,100} against
   phase 3's K1 ground truth,
   recall relative to phase 3's scan ids, an ``ef`` sweep {64, 100, 200}
   over 2,048 queries against a ground truth recomputed through K1 (equal
   to phase 3's), and the id-set overlap with a CPU index carrying the same
   frozen graphs (>= 0.99).  Recall@100 >= 0.5.
3d. paper protocol, q8 HNSW: 3c's graphs carried into a ``quantized="q8"``
   index (rerank_factor 2, exact store on the card): QPS, p50/p99,
   recall@{1,10,100}, recall relative to 3c's ids (>= 0.95) and the overlap
   with the CPU q8 index (>= 0.99).
3e. persist and serve, on phase 3's data and 3c's / 3d's indexes (nothing
   is built at 1M again), artifacts under a temporary directory of
   ``build/`` deleted at the end: (a) 3c's index saved and loaded on the
   card — artifact bytes, save and load seconds (the load with its stack
   upload) beside 3c's build seconds, 3c's ids on the 10k queries (id
   equality 1.0) and 3c's resident bytes; (b) a fresh build resumed from
   that artifact: 0 partitions built, 3c's ids, its seconds; (c) 3d's q8
   index saved and loaded: the saved codes loaded with no re-encode, 3d's
   ids; (d) phase 3's scan index saved and loaded: its ids; (e) the loaded
   HNSW and scan indexes served online through ``AsyncAnnFrontend``
   (max_batch 1024, topk 100) with ``Telemetry`` attached after
   ``warm_traces``: the closed-loop saturation, Poisson points at 0.5x and
   0.9x of it (achieved QPS, request p50/p99, queue vs exec, mean formed
   batch, recall@100, the telemetry stage breakdown), 256 served requests
   equal to ``index.query`` on their formed batches, a controller A/B on
   HNSW (mmpp at 0.9x, ef ladder 80 / 64, the SLO one mean batch execution
   of the 0.9x point: p99, SLO attainment, degrades and recall on vs off); no
   kernel library built or loaded in the serving window, and its
   allocator-segment delta; (f) ``index.query`` on the loaded HNSW index
   for 180 and 1,024 queries, alone and beside a thread that submits at a
   load generator's rate.
3f. the distributed serve step (``serve.retrieval.make_serve_fn`` over a
   ``torch.distributed`` mesh), on phase 3's data, ground truth and batches,
   in worlds of spawned ranks (``launch.mesh.run_world``; indexes from
   ``build_device_index``, saved under a temporary directory of ``build/``
   and memory-mapped by each rank): (a) one rank, NCCL, mesh (data 1,
   model 1): full mode over 1 x 4 RH segments (id-set overlap with phase
   3's K1 ground truth >= 0.999); routed over 1 x 8 RH segments, alpha
   0.15, capacity 422: recall@{1,10,100} (>= 0.5 at 100), overflow, QPS,
   p50/p99 batch latency (CUDA events), K1 launches (one per segment
   scan, every batch), the overlap with the same serve step on CPU tensors
   for 256 queries (>= 0.999), then the same routed configuration with a
   bfloat16 and an int8 corpus (recall relative to f32's ids, resident
   bytes); (b) the paper cell (2 shards x 4 RH segments, routed, f32) on
   two ranks sharing the one card over gloo, mesh (data 1, model 2):
   recall@100, overflow, QPS, p50, each rank's resident bytes, K1
   launches, the overlap with the same world on CPU tensors (>= 0.999).
4. deployment scale: 10M x 512 fp32 in 8 shards x 8 RH segments (halved
   until it fits the host and the card): QPS, p50/p99 batch latency, the
   route/candidates/merge split, recall@100 on 1,000 queries.
2c. K3 vs plain: ``ops.flash_attention`` on CUDA tensors against
   ``ref.flash_attention_ref`` on the same tensors, float32 and bfloat16, D
   in {16, 32, 64, 128}, causal and bidirectional: S in {1, 100, 128, 200,
   1025, 4096} at BH in {1, 15, 30}, and the kernel's tile edges S in {15,
   17, 63, 65, 1000, 4097} at BH in {1, 7} (float32 also S in {31, 33, 127,
   129}, and MLA's instance at S in {15, 17, 31, 33, 63, 127, 129}); MLA's
   instance (q . k head dim 192, v 128) at S in {1, 65, 1000, 4097}, BH in
   {1, 16}; one bfloat16 case with v scaled by 8 (outputs past 4, where a
   bf16 ulp is 3.1e-2).  Max abs error <= 3e-5 (float32) and <= 3e-2
   (bfloat16; times the v scale), the reference's own limits; bfloat16 also
   within ``ref.bf16_agreement`` <= 1 of the plain version in float32 on the
   same inputs (half a bf16 ulp plus 1e-4).  float32 also with v scaled by 8
   (the limit scaled by 8) and with q scaled by 4 (a peaky softmax) at every
   D, and on inputs 4 bytes off the 16-byte grid, which the launcher refuses
   and ``ops.flash_attention`` copies first.  Then K3 / plain / SDPA
   milliseconds and the bound at (32, 8192, 128) causal bf16, seeded: the
   head dim of codeqwen1.5-7b and qwen2-72b; and at (16, 32768, 192 -> 128)
   causal bf16, seeded, with the backend SDPA picked for v's head dim other
   than q's.
2d. K3-bwd vs plain: K3 with its row log-sum-exp (``flash_attention_cuda(...,
   with_lse=True)``) and ``ops.flash_attention_bwd`` on CUDA tensors
   against ``ref.flash_attention_ref`` / ``ref.flash_attention_bwd_ref`` run
   in float32 on the same tensors, float32 and bfloat16, D in {16, 32, 64,
   128} and MLA's (q . k 192, v 128), causal and bidirectional, S in {64,
   1000 (ragged), 4096}; float32 also with q scaled by 4 (a peaky softmax)
   and with v scaled by 8 at S in {64, 1000}, every instance; one float32
   case with a permuted (non-contiguous) dO
   and one with q 4 bytes off the 16-byte grid (the launcher refuses it,
   the wrapper copies).
   Limits per tensor (dq, dk, dv): float32 max |kernel - plain| / max
   |plain| <= 1e-4, bfloat16 ``ref.bf16_agreement`` <= 1; lse within 1e-4
   of the plain version's; K3's output with lse requested bit-equal to the
   output without.  Then K3-bwd / plain / SDPA-backward milliseconds
   (SDPA's forward + backward minus its forward on the backend it picks,
   named; a yardstick) and the
   bound (2.5x the forward's operations BH S^2 (D + Dv), causal half, on
   the bf16 tensor cores, or at 165 TFLOP/s of float32-grade 3xTF32) at
   the training layer shapes of 6b (60, 4096, 64) and 6d (64, 4096, 128)
   and (64, 4096, 192 -> 128), and at (32, 4096, 128), bf16, and (60,
   4096, 64) and (32, 4096, 128) float32, causal, seeded, each checked
   against the plain version before it is timed.
4b. deployment scale, q8, on phase 4's corpus, queries and ground truth,
   after the fp32 index is freed: QPS, p50/p99, the stage split, recall@100,
   resident scan bytes (codes + scales + bias + keys), the exact store's
   device bytes, host encode seconds; one batch with the exact store on the
   host, checked against the device store.
3g. recsys and retrieval_cand, run after 4b while the card's memory is
   free: AutoInt, DIN, SASRec and xDeepFM at full published width, params
   from a seeded ``torch.Generator`` on the card.  For each arch: (b) in
   float32, the forward of the first 64 examples of a seeded batch on the
   card against the same tables copied to the CPU, within 1e-4 of the
   largest |output|; (a) serve_p99: the forward at B = 512 with the cell's
   bf16 params, p50 / p99 ms over 50 calls (CUDA events); (d)
   retrieval_cand: one step (``serve.recsys.retrieval_step``: user tower,
   bf16 projection, K1 at metric ip) over 1,000,000 seeded bf16 candidates
   padded to 1,000,448 rows at the arch's retrieval width (one K1 launch),
   held against ``ref.distance_topk_blocked`` on the same card tensors by
   phase 2's rule; (c) ``make_train_step(recsys_loss_fn(...),
   AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=30))`` on one seeded
   batch of 8,192 (the train_batch cell's 65,536 cut), bf16 params and
   float32 moments: a warm-up step, then 3 timed steps (step p50, peak
   device bytes), losses finite and falling.  For SASRec also (e) 200
   single-user requests through the whole step: p50 / p99 by CUDA events
   and by the host clock (to the ids on the host), one K1 launch each; the
   user tower and projection alone (p50 over 50 calls); and K1 alone at
   (1 x 1,000,448 x 50, k 100 -> 128, ip) against its plain version, its
   bound and ``torch.topk(q @ x.T)``.  (c) also runs one step twice from
   one saved state: params and moments bit-equal (the lookups' backward
   sums in a fixed order, ``models.segment``).  Then (f)
   ``examples/recsys_retrieval_torch.py`` on the card: its R@50.
3h. the checkers (``repro_torch.analysis``): (a) right after 3e,
   ``runtime.race_stress`` (8 submitter threads, ~6 s, seed 0) over 3e's
   loaded paper scan index (1M x 128, 2 shards x 4 segments) with phase
   3's queries: seeded submit / stop / drain churn of instrumented
   ``AsyncAnnFrontend`` + ``SLOController`` pairs, K1 in every formed
   batch; it fails unless the report is ok (no lock-order cycle, no
   guarded-attribute violation, counters and publication consistent) and
   K1 launched; cycles, submitted, completed, cancelled, degrades and the
   lock edges observed are printed.  (b) ``python -m repro_torch.analysis
   --strict`` over the port in a host process started beside phases 5-6d:
   its exit code (it fails on any other than 0), findings by code and the
   suppressions.  (c) after 4b, the footprint model
   (``scalecheck.footprint_report``) at each measured cell's own dims (3,
   3b, 4, 4b: resident scan bytes; 3c, 3d: ``hnsw_resident_bytes``):
   predicted, measured and their ratio; it fails where measured exceeds
   predicted (the model is a bound).
5. LM prefill at the reference's prefill_32k shape: smollm-360m at full
   width and depth, ``serving_config(..., "prefill")`` (bf16, q_chunk 1024),
   bf16 cache, S = 32,768, B = 1 (cut from 32): seconds, tokens/s, K3
   launches (one per layer); K3's output at the first and the last layer
   against the plain version (abs and ``bf16_agreement``); K3 / plain /
   SDPA milliseconds at that layer's (15, 32768, 64) causal bf16 inputs,
   and the bound (bf16 tensor cores).
6. LM serving: ``ServeEngine`` with smollm-360m at full width and depth,
   fp32, 4 slots, max_seq 4096, 8 seeded requests of 1,100-4,000 prompt
   tokens and 32 new tokens: completed, prefill tokens/s, decode steps/s,
   p50 decode step, K3 launches.  Then one 1,100-token request through the
   engine on the card and on the CPU (plain path) with the first 4 layers:
   equal first greedy token, last logits within 1e-3.  Then K3 / plain /
   SDPA milliseconds at each shape the prefills launched K3 at, (15, 4096,
   64) and (15, 2048, 64) causal float32 (seeded inputs), with the launches
   at each, and the bound (float32-grade, 3xTF32).
6b. LM training: ``make_train_step(lm_loss_fn(cfg), AdamWConfig(lr=1e-3,
   warmup_steps=2, total_steps=10), num_micro=4)`` with smollm-360m at full
   width and depth under ``training_config`` (bf16, remat, q_chunk 1024),
   S = 4,096, 16 sequences (the train_4k cell's global batch cut from 256)
   of one seeded ``token_batch``, repeated: one warm-up step, then 5 timed
   steps (CUDA events): step p50, tokens/s, 6 N T / step time as a share
   of the bf16 peak, peak device memory, K3 and K3-bwd launches a step
   against 2 x layers x microbatches (remat runs each forward twice) and
   layers x microbatches.  Losses finite and step 6's below step 1's.  The
   state after step 3 is checkpointed (``train.checkpoint``) and restored
   bit-equal, and steps 4-6 resumed from it give the uninterrupted losses
   within 1e-4 relative.  Then the grads of one step of the first 2 layers
   at full width in float32 (S 1100, q_chunk 256) on the card and on the
   CPU: loss within 1e-5 relative, each grad within 1e-3 of the CPU's
   largest entry, grad norm within 1e-4 relative, and K3-bwd's float32
   path timed at the check's layer shape (15, 1100, 64).  Then ``python -m
   repro_torch.launch.train`` (reduced config, on the card) for 4 steps
   with a checkpoint every 2, and ``--resume``: equal final losses.  Then
   K3 / plain / SDPA milliseconds at the step's layer shape.
6c. MoE and MLA serving: deepseek-moe-16b, then deepseek-v2-lite-16b (the
   first freed before the second is made), each at full published width
   and depth under ``serving_config(..., "prefill")`` (bf16, q_chunk 1024),
   params from a seeded ``torch.Generator`` on the card (resident bytes,
   init seconds).  (a) prefill_32k at B = 1 (cut from 32): one warm-up,
   then one timed prefill of 32,768 seeded tokens into a bf16 cache:
   seconds, tokens/s, K3 once a layer, K3 at the first and last layer
   against the plain version (abs and ``bf16_agreement``), the share of
   (token, k) assignments dropped at capacity 1.25, and K3 / plain / SDPA
   milliseconds at the layer's shape ((16, 32768, 128) and (16, 32768,
   192 -> 128), bf16) with the bound.  (b) ``ServeEngine``, 4 slots,
   max_seq 4096, bf16 cache, 8 seeded requests of 1,100-4,000 prompt
   tokens and 32 new tokens: completed, prefill tokens/s, decode steps/s,
   p50 decode step (CUDA events), K3 launches, cache bytes a token a
   layer.  (c) the first 3 layers (1 dense + 2 MoE) at full width in
   float32, one 1,100-token request through the engine on the card (K3
   float32, MLA's at (192, 128)) and on the CPU: equal first token, last
   logits within 1e-3, (token, expert) routes equal in >= 0.999 of the
   assignments.  Then K3 / plain / SDPA at each shape (b) and (c) ran.
6d. MoE and MLA training: deepseek-moe-16b, then deepseek-v2-lite-16b,
   each under ``training_config`` (the reference's train_4k cell: bf16,
   remat, q_chunk 1024, kv_chunk 2048, capacity factor 1.25) at full
   published width with the depth cut to 4 layers (1 dense + 3 MoE),
   params from a seeded ``torch.Generator`` on the card:
   ``make_train_step(lm_loss_fn(cfg), AdamWConfig(lr=1e-3, warmup_steps=2,
   total_steps=10), num_micro=4)`` on 16 sequences of 4,096 tokens (the
   global batch cut from 256) of one seeded ``token_batch``, repeated: one
   warm-up step (its routes give the share of (token, k) assignments
   dropped at capacity 1.25), then 4 timed steps (CUDA events): step p50 /
   p99, tokens/s, 6 N_active T / step time as a share of the bf16 peak,
   peak device memory, loss and aux at each step (finite; the last loss
   below step 1's), K3 and K3-bwd launches a step against 2 x layers x
   microbatches and layers x microbatches, K3's shape ((64, 4096, 128) /
   (64, 4096, 192 -> 128)).  Then the grads of one step of the first 3
   layers (1 dense + 2 MoE) at full width in float32, one sequence of
   1,100 tokens, on the card and on the CPU: (token, expert) routes
   compared first (>= 0.999 equal; the experts a flipped assignment
   touches leave the grad check, named), loss within 1e-5 relative (aux
   too unless a top-1 route flipped), each grad within 1e-3 of the CPU's
   largest entry, grad norm within 1e-4 relative.  Then K3 / plain / SDPA
   at the step's shape and the check's, and K3-bwd at the check's
   (float32).  No checkpoint of the full-width state is written (~23 GB).
6e. GNN training: DimeNet at full published width (6 blocks, d_hidden
   128, 8 bilinear, 7 spherical, 6 radial) under the GNN cells' config
   (bf16 params; every product after the embedding promotes to float32,
   as in the reference), params from a seeded ``torch.Generator`` on the
   card, ``make_train_step(dimenet_loss_fn(cfg), AdamWConfig(lr=1e-3,
   warmup_steps=2, total_steps=20))`` on one seeded batch, repeated, in
   three cells: (a) molecule, ``random_molecule_batch(128, 30, 64)``, each
   molecule's first 256 triplets, graph targets; (b) full_graph_sm,
   ``power_law_graph(2708, 10556, d_feat=1433)``, triplets capped at 8 an
   edge and padded to 84,448, node targets and ``node_mask``; (c) one
   minibatch_lg lane: ``power_law_graph(232965, 114615892)`` ->
   ``CSRGraph``, ``sample_subgraph`` of 1,024 seeded seeds at fanout (15,
   10) into 16,384 nodes and edges, ``build_triplets(max_triplets=32768)``,
   z per global node, one graph target (the graph's host seconds by stage
   apart from the step's).  Each: nodes, edges, real triplets, a warm-up
   step, then 5 timed steps (CUDA events): step p50, peak device bytes,
   losses and grad norms (finite losses, one of them below step 1's unless
   every grad norm overflowed float32, which zeroes the clipped update, as
   in the reference, on molecules at init).  Each also runs two steps twice
   from one saved state (params and moments bit-equal), and one step's
   grads at full width in float32 on the card and on the CPU from the same
   params: for (a) and (b) loss within 1e-5 relative, each grad within
   1e-3 of the CPU's largest, the grad norm (summed in float64) within
   1e-4 relative; for (c) the same numbers, recorded.  No kernel of the kernel
   layer launches in 6e (checked).  After phase 7, one step of each cell
   under ``torch.profiler``: kernel launches a step, device busy and idle
   share, the top kernels.
6f. the sharded cells and the dry run (``configs.families``,
   ``launch.dryrun``): (a) every arch's ``smoke`` on the card (the
   reference's reduced-config steps and asserts): metrics and seconds; (b)
   in a world of one rank over NCCL (``run_world``, mesh data 1 x model
   1), smollm-360m's ``build_cell(train_4k)`` at full width and depth, the
   batch cut to 6b's (16 x 4,096, ``num_micro`` 4), params and moments
   DTensors with the cell's placements, K3 / K3-bwd through ``local_map``:
   a warm-up step, then 3 timed (CUDA events): step p50, peak device
   bytes, K3 and K3-bwd launches a step (2 x layers x microbatches and
   layers x microbatches), the losses against ``make_train_step`` on the
   same params and batch as plain tensors (bit-equal, or within 1e-6
   relative: which is recorded); (c) in the same world, one ogb_products
   lane at its full lane shape through ``GNNArch.build_cell``: a seeded
   halo partition of 16,384 nodes (half owned, the rest masked), 262,144
   edges, triplets capped at 4 an edge padded to 1,048,576, bf16 features
   of width 100; a warm-up step, then 3 timed (step p50, peak, finite
   losses), two steps run twice from one state (bit-equal), and one step's
   loss and grads in float32 on the lane cut to an eighth, card against
   CPU (recorded); (d) the dry run, in a host process started before phase
   5 (it needs no card): the cells of (b) and (c) on a fake world of one
   (predicted peak against the measured one, the calibration), and
   deepseek-moe-16b's and deepseek-v2-lite-16b's train_4k at full depth on
   16 x 16: per-rank peak, argument bytes, flops and seconds.  6e's
   Reddit-sized graph and its sampled lane are built in a second host
   process started with it, beside the card's phases 5-6d.
7. the HNSW beam under ``torch.profiler``, last but 6e's launch count (a
   profiler session slows the rest of the process's kernel launches): one
   batch of 3c and one of 3d, each on an index carrying 3c's graphs again —
   kernel launches, device busy time and idle share, the top kernels by
   device time.
8. the kernels line: launches on the main path (K1: phases 3, 3c's ground
   truth, 3e, 3h (a), 3f, 4 and 3g; K2: 3b and 4b; K3: 5, 6, 6b's, 6d's and 6f's
   forward launches and 6c; K3-bwd: 6b's, 6d's and 6f's steps and their
   card-vs-CPU checks; the HNSW beam and DimeNet's training (6e, 6f) are torch ops and
   launch none of them, which the line's ``not_launched_by`` says), max
   error, kernel / plain / library times at a main-path shape, and each
   bound; K1, K3 and K3-bwd
   also by shape (``instances``: K1's scan phases at the paper partition
   and 3g at the retrieval_cand shape; K3's bf16 32k prefill, each float32
   bucket, the bf16 training step, 6c's two 32k prefills, its engine
   buckets and its float32 checks, 6d's steps and checks, 6f's cell steps
   (6b's layer shape, timed there); K3-bwd's bf16 training steps (6b, 6d's
   GQA 128 and MLA (192, 128), 6f's) and their float32 checks; each with
   its launches, times and bound; K2's at the paper and deployment q8
   partitions).  Before it, K1's and K2's launches by (B, N = n_valid, D,
   k_pad) over the same windows (``ops.LAUNCHES_BY_SHAPE``), summing to
   the line's counts.  Every phase's seconds are in the ``total`` record's
   ``by_phase``.

Needs torch with CUDA, nvcc and one card; exits non-zero without them.
"""

from __future__ import annotations

import copy
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
TOL = 3e-4
# H100 SXM peaks (NVIDIA data sheet): float32-grade products, dense int8
# and bf16 tensor cores, HBM3.  A float32-grade product is fastest as a
# 3xTF32 split on the tensor cores (three TF32 MMAs at 495 TFLOP/s dense,
# the route of PyTorch's float32 SDPA), not on the 67 TFLOP/s fp32 pipe.
PEAK_F32_FLOPS = 495e12 / 3
PEAK_INT8_OPS = 1979e12
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
K1_SOURCE = "src/repro_torch/kernels/csrc/distance_topk.cu"
K1_REPLACES = "src/repro/kernels/distance_topk.py:84"
K2_SOURCE = "src/repro_torch/kernels/csrc/distance_topk_q8.cu"
K2_REPLACES = "src/repro/kernels/distance_topk_q8.py:38"
K3_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
K3_REPLACES = "src/repro/kernels/flash_attention.py:28"
#: K3's limits against its plain version (tests/test_flash_attention.py:26,50)
K3_TOL = {torch.float32: 3e-5, torch.bfloat16: 3e-2}
#: K3's operations bound per dtype
K3_PEAK = {torch.float32: PEAK_F32_FLOPS, torch.bfloat16: PEAK_BF16_FLOPS}
K3_BWD_SOURCE = "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"
#: the JAX package has no backward kernel: its gradient is autodiff of this
K3_BWD_REPLACES = "src/repro/models/layers.py:137"
#: K3-bwd's float32 limit: max |kernel - plain| / max |plain| per tensor
K3_BWD_REL_TOL = 1e-4


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` runs (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def shape_launches(name: str = "distance_topk") -> dict:
    """K1's (or K2's) launches by shape since the last ``ops.reset_launches``:
    {"B,N,D,k_pad": launches}, N the rows scanned (n_valid)."""
    from repro_torch.kernels import ops

    return {",".join(map(str, k)): n for k, n in ops.LAUNCHES_BY_SHAPE[name].items()}


def add_shapes(*counts: dict) -> dict:
    out = {}
    for c in counts:
        for k, n in c.items():
            out[k] = out.get(k, 0) + n
    return out


def compare_topk(d_k, i_k, d_p, i_p, label: str, tol: float = TOL) -> tuple[float, int]:
    """Hold kernel output against the plain version's: finite pattern equal,
    distances within ``tol``, ids equal as sets per row up to one swap at
    the k-th place between near-equal distances.  Returns (max abs error,
    rows with a swap)."""
    d_k, i_k, d_p, i_p = (t.cpu().numpy() for t in (d_k, i_k, d_p, i_p))
    if d_k.shape != d_p.shape or i_k.shape != i_p.shape:
        raise AssertionError(f"{label}: shapes {d_k.shape} vs {d_p.shape}")
    fin = np.isfinite(d_p)
    if not np.array_equal(fin, np.isfinite(d_k)):
        raise AssertionError(f"{label}: finite patterns differ")
    if not np.array_equal(i_k[~fin], i_p[~fin]) or np.any(i_k[~fin] != -1):
        raise AssertionError(f"{label}: padding ids differ")
    err = float(np.abs(d_k[fin] - d_p[fin]).max()) if fin.any() else 0.0
    if not np.allclose(d_k[fin], d_p[fin], rtol=tol, atol=tol):
        raise AssertionError(f"{label}: distances differ, max abs err {err}")
    swaps = 0
    for r in range(d_p.shape[0]):
        f = fin[r]
        sk, sp = set(i_k[r][f].tolist()), set(i_p[r][f].tolist())
        if sk == sp:
            continue
        if len(sk ^ sp) != 2:
            raise AssertionError(f"{label}: row {r} id sets differ by {len(sk ^ sp)}")
        kth = d_p[r][f][-1]
        (extra,) = sk - sp
        d_extra = d_k[r][list(i_k[r]).index(extra)]
        if abs(d_extra - kth) > tol * (1 + abs(kth)):
            raise AssertionError(f"{label}: row {r} swap is not a k-th place tie")
        swaps += 1
    return err, swaps


def phase_card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    ptxas = [
        line.strip() for log in logs.values() for line in log.splitlines()
        if "registers" in line or "spill" in line or "Compiling entry" in line
    ]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": list(logs), "ptxas": ptxas})
    return smi


def chunk_edges(B: int, k_pads=(128, 256, 512), lo: int = 4000, hi: int = 40_000) -> list:
    """(k, n_valid) pairs whose last corpus chunk (``split_plan`` on this
    card) holds one row, or one row short of a whole chunk, at each k_pad."""
    from repro_torch.kernels.distance_topk import split_plan

    sm = torch.cuda.get_device_properties(0).multi_processor_count
    out = []
    for k_pad in k_pads:
        want = {1, -1}
        for nv in range(lo, hi):
            ns, ch = split_plan(B, nv, sm, k_pad)
            edge = 1 if nv % ch == 1 else -1 if nv % ch == ch - 1 else 0
            if ns > 1 and edge in want:
                want.discard(edge)
                out.append((k_pad * 3 // 4, nv))
            if not want:
                break
    return out


def tile_edge_cases(k_pads=(128, 256, 512)) -> list:
    """The scan's tile edges, as (metric, k, D, B, N, n_valid): B = 64 +- 1
    queries, N = 64 +- 1 rows, a chunk edge +- 1 at each k_pad."""
    from repro_torch.kernels.distance_topk import TILE_N, TILE_Q

    cases = [("l2", k_pad * 3 // 4, 64, B, 5003, None)
             for B in (TILE_Q - 1, TILE_Q + 1) for k_pad in k_pads]
    cases += [("ip", k, 32, 37, N, None) for N in (TILE_N - 1, TILE_N + 1) for k in (10, 60)]
    cases += [("l2", k, 48, TILE_Q + 1, nv + 100, nv) for k, nv in chunk_edges(TILE_Q + 1, k_pads)]
    return cases


def batch_edge_cases(metrics=("l2", "ip")) -> list:
    """The scans' batch edges, as (metric, k, D, B, N, n_valid): B around
    the small-batch threshold (1, 2, B_SMALL, B_SMALL + 1) and the
    warpgroup's 64 queries (63, 65), at ragged and whole D, n_valid < N,
    each k_pad."""
    from repro_torch.kernels.distance_topk import B_SMALL

    return [(metrics[(i + j) % len(metrics)], k, D, B, 5003, 4001)
            for i, B in enumerate((1, 2, B_SMALL, B_SMALL + 1, 63, 65))
            for j, D in enumerate((7, 18, 50, 128, 512)) for k in (100, 200, 400)]


def phase_kernel_vs_plain() -> float:
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for metric in ("l2", "ip", "cos"):
        for k in (10, 100, 200, 400):
            for D in (50, 128, 960, 2048):
                cases.append((metric, k, D, 37, 5003, None))
    cases += [
        ("l2", 100, 128, 19, 5003, 3001),  # n_valid < N
        ("ip", 200, 50, 9, 4097, 257),     # n_valid < N, several chunks
        ("l2", 200, 128, 5, 150, None),    # k > N
        ("cos", 100, 960, 3, 64, 40),      # k > N and n_valid < N
        ("l2", 10, 128, 1000, 200_000, None),  # split across many chunks
        ("l2", 10, 64, 4, 0, None),        # N == 0
    ]
    cases += tile_edge_cases()
    cases += [(m, 100, D, 37, 5003, None) for D in (1, 7, 9, 33) for m in ("l2", "ip")]
    cases += batch_edge_cases()
    max_err, swaps = 0.0, 0
    for metric, k, D, B, N, nv in cases:
        q = torch.randn(B, D, generator=gen, device="cuda")
        x = torch.randn(N, D, generator=gen, device="cuda")
        d_k, i_k = ops.distance_topk(q, x, k, metric, n_valid=nv)
        d_2, i_2 = ops.distance_topk(q, x, k, metric, n_valid=nv)
        torch.cuda.synchronize()
        if not (torch.equal(d_k, d_2) and torch.equal(i_k, i_2)):
            raise AssertionError(f"{metric} k={k} D={D} B={B} N={N}: two runs differ")
        if N == 0:
            if not (torch.isinf(d_k).all() and (i_k == -1).all()):
                raise AssertionError("N == 0 must give (inf, -1)")
            continue
        d_p, i_p = ref.distance_topk_blocked(q, x, k, metric, n_valid=nv)
        err, sw = compare_topk(d_k, i_k, d_p, i_p, f"{metric} k={k} D={D} B={B} N={N} nv={nv}")
        max_err, swaps = max(max_err, err), swaps + sw
    emit({"phase": "kernel_vs_plain", "cases": len(cases), "max_abs_err": max_err,
          "tie_swaps": swaps, "rtol": TOL, "atol": TOL, "repeat": "bit-equal"})
    return max_err


def time_kernel(q: torch.Tensor, x: torch.Tensor, k: int, label: str, metric: str = "l2",
                n_valid: int | None = None) -> dict:
    """K1 at one main-path shape: agreement with the plain version, K1 /
    plain / library milliseconds, and K1's bound.  Rows at or past
    ``n_valid`` are padding: neither read nor counted."""
    from repro_torch.common.utils import next_pow2
    from repro_torch.kernels import ref
    from repro_torch.kernels.distance_topk import distance_topk_cuda

    B, D = q.shape
    N = x.shape[0] if n_valid is None else n_valid
    k_pad = max(next_pow2(k), 128)
    kern = lambda: distance_topk_cuda(q, x, k_pad=k_pad, n_valid=N, metric=metric)
    plain = lambda: ref.distance_topk_blocked(q, x, k, metric, n_valid=N)
    xv = x[:N]

    def library():
        if metric == "ip":
            return torch.topk(q @ xv.T, k, dim=1)
        xn = (xv * xv).sum(-1)
        return torch.topk(torch.addmm(xn, q, xv.T, alpha=-2.0), k, dim=1, largest=False)

    d_k, i_k = kern()
    d_k = d_k[:, :k]
    if metric == "l2":
        qn = (q * q).sum(-1, keepdim=True)
        d_k = torch.where(torch.isinf(d_k), d_k, d_k + qn)
    d_p, i_p = plain()
    err, _ = compare_topk(d_k, i_k[:, :k], d_p, i_p, f"main-path shape {label}")
    ms = cuda_ms(kern)
    plain_ms = cuda_ms(plain, iters=5)
    library_ms = cuda_ms(library)
    flops = 2.0 * B * N * D  # q.x for every pair
    if metric == "l2":
        flops += 2.0 * N * D  # ||x||^2 per row
    nbytes = 4.0 * (B * D + N * D) + 8.0 * B * k_pad
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES
    rec = {"shape": label, "B": B, "N": N, "D": D, "k": k, "k_pad": k_pad, "metric": metric,
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": 1e3 * max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "achieved_tflops": flops / (ms * 1e-3) / 1e12}
    emit({"phase": "kernel_timing", **rec})
    return rec


def compare_q8_topk(d_k, i_k, d_p, i_p, scores_of, label: str) -> tuple[float, int]:
    """Hold K2's output against its plain version's: scores bit-equal, ids
    equal up to swaps between equal scores at the k-th place, each row's
    ids distinct, and every id the kernel returns carries its own plain
    score (``scores_of(row, ids)``).  Returns (max abs score difference,
    rows with a tie swap)."""
    d_k, i_k, d_p, i_p = (t.cpu().numpy() for t in (d_k, i_k, d_p, i_p))
    if d_k.shape != d_p.shape or i_k.shape != i_p.shape:
        raise AssertionError(f"{label}: shapes {d_k.shape} vs {d_p.shape}")
    fin = np.isfinite(d_p)
    err = float(np.abs(d_k[fin] - d_p[fin]).max()) if fin.any() else 0.0
    if not np.array_equal(d_k, d_p):
        raise AssertionError(f"{label}: scores not bit-equal, max abs diff {err}")
    swaps = 0
    for r in range(d_k.shape[0]):
        fin = np.isfinite(d_k[r])
        if np.any(i_k[r][~fin] != -1) or len(set(i_k[r][fin].tolist())) != fin.sum():
            raise AssertionError(f"{label}: row {r} padding or duplicate ids")
        if not fin.any():
            continue
        kth = d_k[r][fin][-1]
        better = d_k[r] < kth
        if set(i_k[r][better].tolist()) != set(i_p[r][better].tolist()):
            raise AssertionError(f"{label}: row {r} ids differ above the k-th score")
        if not np.array_equal(scores_of(r, i_k[r][fin]), d_k[r][fin]):
            raise AssertionError(f"{label}: row {r} ids do not carry their scores")
        swaps += int(set(i_k[r][fin].tolist()) != set(i_p[r][fin].tolist()))
    return err, swaps


def q8_case(q: torch.Tensor, x: np.ndarray, metric: str):
    """Encode ``x`` with the numpy codec, upload it, and quantize ``q`` on
    the card; checks the torch query codes against the numpy codec's."""
    from repro_torch.quant.codec import quantize_q8, quantize_queries_q8, quantize_queries_q8_t

    qc = quantize_q8(x, metric)
    codes = torch.from_numpy(qc.codes).cuda()
    scales = torch.from_numpy(qc.scales).cuda()
    norms2 = torch.from_numpy(qc.norms2).cuda()
    q_eff = q / q.norm(dim=-1, keepdim=True).clamp_min(1e-12) if metric == "cos" else q
    q_codes, q_scale = quantize_queries_q8_t(q_eff, scales)
    ref_codes, ref_scale = quantize_queries_q8(q_eff.cpu().numpy(), qc.scales)
    if not (np.array_equal(q_codes.cpu().numpy(), ref_codes)
            and np.array_equal(q_scale.cpu().numpy(), ref_scale)):
        raise AssertionError(f"torch query codes differ from the numpy codec ({metric})")
    return codes, scales, norms2, q_codes, q_scale


def phase_q8_kernel_vs_plain() -> float:
    from repro_torch.kernels import ops, ref

    rng = np.random.default_rng(0)
    cases = []
    for metric in ("l2", "ip", "cos"):
        for k in (10, 38, 120, 228, 400):
            for D in (50, 128, 512, 960, 2048):
                cases.append((metric, k, D, 37, 5003, None))
    cases += [
        ("l2", 120, 128, 19, 5003, 3001),  # n_valid < N
        ("ip", 228, 50, 9, 4097, 257),     # n_valid < N, several chunks
        ("l2", 400, 128, 5, 150, None),    # k > N
        ("cos", 100, 960, 3, 64, 40),      # k > N and n_valid < N
        ("l2", 38, 512, 345, 156_773, None),  # deployment partition shape
        ("ip", 400, 2048, 1000, 50_001, None),  # k_pad 512, many query tiles
        ("l2", 10, 128, 4, 0, None),       # N == 0
    ]
    cases += tile_edge_cases()
    cases += [(m, 100, D, 37, 5003, None) for D in (31, 33) for m in ("l2", "ip")]
    cases += batch_edge_cases(("l2", "ip", "cos"))
    max_err, swaps = 0.0, 0
    for metric, k, D, B, N, nv in cases:
        label = f"q8 {metric} k={k} D={D} B={B} N={N} nv={nv}"
        q = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32)).cuda()
        x = rng.standard_normal((N, D)).astype(np.float32)
        codes, scales, norms2, q_codes, q_scale = q8_case(q, x, metric)
        corpus = type("Q8", (), {"codes": codes, "scales": scales, "norms2": norms2,
                                 "metric": metric})()
        d_w, i_w = ops.distance_topk_q8(q, corpus, k, metric, n_valid=nv)
        torch.cuda.synchronize()
        if N == 0:
            if not (torch.isinf(d_w).all() and (i_w == -1).all()):
                raise AssertionError("N == 0 must give (inf, -1)")
            continue
        metric_k = "l2" if metric == "l2" else "ip"
        d_k, i_k = ops.distance_topk_q8_codes(q_codes, codes, q_scale, norms2, k, metric_k,
                                              n_valid=nv)
        d_2, i_2 = ops.distance_topk_q8_codes(q_codes, codes, q_scale, norms2, k, metric_k,
                                              n_valid=nv)
        if not (torch.equal(d_k, d_2) and torch.equal(i_k, i_2)):
            raise AssertionError(f"{label}: two runs differ")
        d_p, i_p = ref.distance_topk_q8_blocked(q_codes, codes, q_scale, norms2, k, metric_k,
                                                n_valid=nv)

        def scores_of(r, ids):
            idx = torch.from_numpy(ids.astype(np.int64)).cuda()
            return ref.q8_score_matrix(q_codes[r: r + 1], codes[idx], q_scale[r: r + 1],
                                       norms2[idx], metric_k)[0].cpu().numpy()

        err, sw = compare_q8_topk(d_k, i_k, d_p, i_p, scores_of, label)
        max_err, swaps = max(max_err, err), swaps + sw
        # the wrapper returns the same id sets (k > N pads with (inf, -1))
        kk = min(k, N)
        for r_w, r_k in zip(i_w[:, :kk].tolist(), i_k[:, :kk].tolist()):
            if set(r_w) - {-1} != set(r_k) - {-1}:
                raise AssertionError(f"{label}: wrapper ids differ from the kernel's")
    emit({"phase": "q8_kernel_vs_plain", "cases": len(cases), "scores": "bit-equal",
          "max_abs_err": max_err, "tie_swaps": swaps, "repeat": "bit-equal"})
    return max_err


def time_q8_kernel(part, q_lane: torch.Tensor, C: int, label: str) -> dict:
    """K2 at one main-path shape (a q8 partition and its routed queries):
    bit-equality with the plain version, K2 / plain / library milliseconds,
    and K2's bound."""
    from repro_torch.common.utils import next_pow2
    from repro_torch.kernels import ref
    from repro_torch.kernels.distance_topk_q8 import distance_topk_q8_cuda
    from repro_torch.quant.codec import quantize_queries_q8_t

    q_codes, q_scale = quantize_queries_q8_t(q_lane, part.scales)
    codes, bias = part.codes, part.bias
    metric_k = "l2" if part.metric == "l2" else "ip"
    B, D = q_codes.shape
    N = codes.shape[0]
    k_pad = max(next_pow2(C), 128)
    kern = lambda: distance_topk_q8_cuda(q_codes, codes, q_scale, bias, k_pad=k_pad,
                                         n_valid=N, metric=metric_k)
    plain = lambda: ref.distance_topk_q8_blocked(q_codes, codes, q_scale, bias, C, metric_k)
    # yardstick: cuBLASLt int8 GEMM + rescale + torch.topk (rows padded to a
    # multiple of 8 for _int_mm, outside the timed call)
    n8 = -(-N // 8) * 8
    x_t = torch.nn.functional.pad(codes, (0, 0, 0, n8 - N)).T
    bias8 = torch.nn.functional.pad(bias, (0, n8 - N), value=float("inf"))

    def library():
        qx = torch._int_mm(q_codes, x_t).to(torch.float32) * q_scale[:, None]
        s = bias8[None, :] - 2.0 * qx if metric_k == "l2" else -qx
        return torch.topk(s, C, dim=1, largest=False)

    d_k, i_k = kern()
    d_p, i_p = plain()

    def scores_of(r, ids):
        idx = torch.from_numpy(ids.astype(np.int64)).cuda()
        return ref.q8_score_matrix(q_codes[r: r + 1], codes[idx], q_scale[r: r + 1], bias[idx],
                                   metric_k)[0].cpu().numpy()

    err, _ = compare_q8_topk(d_k[:, :C], i_k[:, :C], d_p, i_p, scores_of,
                             f"main-path shape {label}")
    ms = cuda_ms(kern)
    plain_ms = cuda_ms(plain, iters=5)
    library_ms = cuda_ms(library)
    ops_ = 2.0 * B * N * D
    nbytes = N * D + 4.0 * N + B * D + 4.0 * B + 8.0 * B * k_pad
    t_ops, t_bytes = ops_ / PEAK_INT8_OPS, nbytes / PEAK_HBM_BYTES
    rec = {"shape": label, "B": B, "N": N, "D": D, "k": C, "k_pad": k_pad, "max_abs_err": err,
           "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": 1e3 * max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "achieved_tops": ops_ / (ms * 1e-3) / 1e12}
    emit({"phase": "q8_kernel_timing", **rec})
    return rec


def stage_split(idx, batches, topk: int) -> dict:
    """Mean ms per batch of the executor's route / candidates / merge
    stages, each closed by a CUDA event; "host_other" is the rest of a
    whole ``query`` call (upload, result copy, Python).  For a q8 index the
    candidates stage is split into stage 1 and the exact re-rank, timed by
    the executor's own re-rank marks (``core.plan.StageTimer``: CUDA events,
    no added sync), and the K2 launches of each batch are checked against
    its routed partitions with C < n."""
    from repro_torch.kernels import ops

    from repro_torch.core.plan import StageTimer

    ex = idx._exec
    cfg = idx.config
    q8 = cfg.quantized == "q8"
    split = {"route": 0.0, "candidates": 0.0, "merge": 0.0, "host_other": 0.0}
    if q8:
        split.update(stage1=0.0, rerank=0.0)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    for qb in batches:
        ev[4].record()
        idx.query(qb, topk)
        ev[5].record()
        q_dev = torch.from_numpy(qb).cuda()
        ev[0].record()
        plan = ex.plan(q_dev, topk)
        if q8:  # the executor's own re-rank marks: CUDA events, no added sync
            plan.timer = StageTimer(q_dev.device, None)
        ev[1].record()
        ops.reset_launches()
        ex.candidates(plan)
        ev[2].record()
        launched = ops.KERNEL_LAUNCHES["distance_topk_q8"]
        ex.merge(plan)
        ev[3].record()
        ev[3].synchronize()
        for name, a, b in (("route", 0, 1), ("candidates", 1, 2), ("merge", 2, 3)):
            split[name] += ev[a].elapsed_time(ev[b]) / len(batches)
        split["host_other"] += (ev[4].elapsed_time(ev[5]) - ev[0].elapsed_time(ev[3])) / len(batches)
        if q8:
            rr_ms = 1e3 * sum(plan.timer.seconds(a, b) for a, b in plan.timer.rerank)
            split["rerank"] += rr_ms / len(batches)
            split["stage1"] += (ev[1].elapsed_time(ev[2]) - rr_ms) / len(batches)
            C = cfg.rerank_factor * plan.pstk
            want = sum(1 for (s, g), p in idx.partitions.items()
                       if cfg.engine == "scan" and plan.sels[g].numel() and C < p.size)
            if launched != want:
                raise AssertionError(f"K2 launched {launched} times for {want} partitions")
    return split


def build_split(idx) -> dict:
    """Seconds of the build's fit / assign / partition stages (the last
    includes the int8 encode of a q8 index, also given on its own)."""
    keys = ("segmenter_fit_seconds", "assign_seconds", "build_wall_seconds", "q8_encode_seconds")
    return {k: idx.build_stats[k] for k in keys if k in idx.build_stats}


def overlap(a: np.ndarray, b: np.ndarray) -> float:
    """Mean per-row |set(a) & set(b)| / |set(b)| over valid ids."""
    vals = []
    for ra, rb in zip(a, b):
        sb = {int(v) for v in rb if v >= 0}
        sa = {int(v) for v in ra if v >= 0}
        vals.append(len(sa & sb) / max(len(sb), 1))
    return float(np.mean(vals))


def check_results(d: np.ndarray, i: np.ndarray, B: int, k: int, n: int, label: str) -> None:
    if d.shape != (B, k) or i.shape != (B, k):
        raise AssertionError(f"{label}: shapes {d.shape} {i.shape}")
    valid = i >= 0
    if not (np.isfinite(d[valid]).all() and np.isinf(d[~valid]).all()):
        raise AssertionError(f"{label}: distances do not match the id pattern")
    if i.max() >= n or not valid.any():
        raise AssertionError(f"{label}: ids out of range")
    if np.any(np.diff(np.where(valid, d, np.inf), axis=1) < 0):
        raise AssertionError(f"{label}: rows not ascending")


def phase_paper(n: int = 1_000_000, n_queries: int = 10_000, batch: int = 1024,
                topk: int = 100) -> dict:
    from repro_torch.core import LannsConfig, LannsIndex, brute_force_topk, recall_table
    from repro_torch.data.synthetic import sift_like
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    corpus, queries = sift_like(n=n, d=128, n_queries=n_queries, seed=0)
    gen_s = time.perf_counter() - t0
    cfg = LannsConfig(num_shards=2, num_segments=4, segmenter="rh", alpha=0.15,
                      engine="scan", metric="l2")
    idx = LannsIndex(cfg)
    t0 = time.perf_counter()
    idx.build(corpus)
    build_s = time.perf_counter() - t0
    resident = sum(p.vectors.numel() * 4 + p.keys.numel() * 8 for p in idx.partitions.values())
    idx.query(queries[:batch], topk)  # warm-up: allocator, first launch

    ops.reset_launches()
    ids, dists = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in range(0, len(queries), batch):
        d, i = idx.query(queries[s: s + batch], topk)
        dists.append(d)
        ids.append(i)
    query_s = time.perf_counter() - t0
    launches_query = ops.KERNEL_LAUNCHES["distance_topk"]
    _, gt_i = brute_force_topk(queries, corpus, topk)
    launches = ops.KERNEL_LAUNCHES["distance_topk"]
    by_shape = shape_launches()
    d_all, i_all = np.concatenate(dists), np.concatenate(ids)
    check_results(d_all, i_all, len(queries), topk, len(corpus), "paper")
    split = stage_split(
        idx, [queries[s: s + batch] for s in range(0, min(8 * batch, len(queries)), batch)], topk
    )
    rec = recall_table(i_all, gt_i, (1, 10, 100))

    cpu = LannsIndex(cfg, device="cpu").build(corpus)
    n_cpu = 256
    _, i_cpu = cpu.query(queries[:n_cpu], topk)
    ov = overlap(i_all[:n_cpu], i_cpu)
    emit({"phase": "paper", "n": len(corpus), "d": 128, "queries": len(queries),
          "config": "2 shards x 4 RH segments, alpha 0.15, scan, l2",
          "topk": topk, "batch": batch, "datagen_s": gen_s, "build_s": build_s,
          "build_stats": build_split(idx),
          "qps": len(queries) / query_s,
          "k1_launches_per_batch": launches_query / -(-len(queries) // batch),
          "split_ms": split,
          "recall": {f"R@{k}": v for k, v in rec.items()},
          "resident_scan_bytes": resident, "cpu_overlap_256": ov})
    if ov < 0.999:
        raise AssertionError(f"GPU vs CPU id-set overlap {ov} < 0.999")
    if rec[100] < 0.5:
        raise AssertionError(f"recall@100 {rec[100]} is implausibly low")
    # a main-path shape for the kernel line: partition (0, 0)'s routed batch
    q_dev = torch.from_numpy(queries[:batch]).cuda()
    plan = idx._exec.plan(q_dev, topk)
    sel = plan.sels[0]
    q_sel = q_dev.index_select(0, sel).contiguous()
    timing = time_kernel(q_sel, idx.partitions[(0, 0)].vectors, plan.pstk,
                         "paper: partition (0,0), first batch")
    time_kernel(q_sel, idx.partitions[(0, 0)].vectors, 400, "paper: partition (0,0), k_pad 512")
    # and the ground truth's shape: one 4096-query block over the corpus
    time_kernel(torch.from_numpy(queries[:4096]).cuda(), torch.from_numpy(corpus).cuda(),
                topk, "paper: brute-force query block")
    return {"launches": launches, "by_shape": by_shape, "timing": timing, "index": idx,
            "footprint": footprint_record(idx, "fp32_scan", resident),
            "data": (corpus, queries, gt_i, i_all)}


def phase_paper_q8(corpus, queries, gt_i, fp32_ids, batch: int = 1024, topk: int = 100) -> dict:
    from repro_torch.core import LannsConfig, LannsIndex, recall_at_k, recall_table
    from repro_torch.kernels import ops

    cfg = LannsConfig(num_shards=2, num_segments=4, segmenter="rh", alpha=0.15,
                      engine="scan", metric="l2", quantized="q8", rerank_factor=2,
                      rerank_store="auto")
    idx = LannsIndex(cfg)
    t0 = time.perf_counter()
    idx.build(corpus)
    build_s = time.perf_counter() - t0
    idx.query(queries[:batch], topk)  # warm-up: exact-store upload, first launch

    ops.reset_launches()
    ids, dists = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in range(0, len(queries), batch):
        d, i = idx.query(queries[s: s + batch], topk)
        dists.append(d)
        ids.append(i)
    query_s = time.perf_counter() - t0
    launches = dict(ops.KERNEL_LAUNCHES)
    by_shape = shape_launches("distance_topk_q8")
    if launches["distance_topk_q8"] <= 0 or launches["distance_topk"] != 0:
        raise AssertionError(f"paper q8: launches {launches}")
    d_all, i_all = np.concatenate(dists), np.concatenate(ids)
    check_results(d_all, i_all, len(queries), topk, len(corpus), "paper q8")
    split = stage_split(
        idx, [queries[s: s + batch] for s in range(0, min(8 * batch, len(queries)), batch)], topk
    )
    rec = recall_table(i_all, gt_i, (1, 10, 100))
    rel = recall_at_k(i_all, fp32_ids, topk)

    cpu = LannsIndex(cfg, device="cpu").build(corpus)
    n_cpu = 256
    _, i_cpu = cpu.query(queries[:n_cpu], topk)
    ov = overlap(i_all[:n_cpu], i_cpu)
    ex = idx._q8_executor()
    emit({"phase": "paper_q8", "n": len(corpus), "d": corpus.shape[1], "queries": len(queries),
          "config": "2 shards x 4 RH segments, alpha 0.15, scan, l2, q8, rerank_factor 2, "
                    f"rerank_store auto ({ex.rerank_store})",
          "topk": topk, "batch": batch, "build_s": build_s,
          "q8_encode_s": idx.build_stats["q8_encode_seconds"],
          "qps": len(queries) / query_s,
          "k2_launches_per_batch": launches["distance_topk_q8"] / -(-len(queries) // batch),
          "split_ms": split,
          "recall": {f"R@{k}": v for k, v in rec.items()},
          "recall_rel_fp32_at_100": rel, "cpu_overlap_256": ov,
          "resident_scan_bytes": ex.resident_bytes(),
          "exact_store_device_bytes": ex.exact_store_device_bytes()})
    if rel < 0.99:
        raise AssertionError(f"q8 recall relative to fp32 {rel} < 0.99")
    if ov < 0.999:
        raise AssertionError(f"q8 GPU vs CPU id-set overlap {ov} < 0.999")
    # a main-path shape for the kernel line: partition (0, 0)'s routed batch
    q_dev = torch.from_numpy(queries[:batch]).cuda()
    plan = idx._exec.plan(q_dev, topk)
    q_sel = q_dev.index_select(0, plan.sels[0])
    timing = time_q8_kernel(ex.parts[(0, 0)], q_sel, cfg.rerank_factor * plan.pstk,
                            "paper q8: partition (0,0), first batch")
    time_q8_kernel(ex.parts[(0, 0)], q_sel, 400, "paper q8: partition (0,0), k_pad 512")
    return {"launches": launches["distance_topk_q8"], "by_shape": by_shape, "timing": timing,
            "footprint": footprint_record(idx, "q8_scan", ex.resident_bytes())}


def device_profile(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: the CUDA kernels it
    launched, their summed and merged (busy) device time, and the wall
    time of the profiled call.  The profiler's own host overhead inflates
    the wall time, so ``idle_share`` (1 - busy / wall) is an upper bound."""
    from torch.profiler import DeviceType, ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kernels = [e for e in dev if not e.name.startswith(("Memcpy", "Memset"))]
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, end = 0.0, -np.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name: dict[str, list] = {}
    for e in kernels:
        acc = by_name.setdefault(e.name[:80], [0, 0.0])
        acc[0] += 1
        acc[1] += e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    return {"kernel_launches": len(kernels), "device_events": len(dev),
            "kernel_ms": sum(e.time_range.elapsed_us() for e in kernels) / 1e3,
            "busy_ms": busy / 1e3, "wall_ms": wall_us / 1e3,
            "idle_share": None if not dev else 1.0 - busy / wall_us,
            "top_kernels": [{"name": n, "count": c, "ms": ms} for n, (c, ms) in top]}


def timed_batches(idx, batches, topk, **kw):
    """Query every batch: (dists, ids, host seconds of the whole loop, CUDA
    event ms per batch)."""
    lat, dists, ids = [], [], []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for qb in batches:
        start.record()
        d, i = idx.query(qb, topk, **kw)
        end.record()
        end.synchronize()
        lat.append(start.elapsed_time(end))
        dists.append(d)
        ids.append(i)
    return np.concatenate(dists), np.concatenate(ids), time.perf_counter() - t0, np.asarray(lat)


def beam_per_batch(n_batches: int) -> dict:
    from repro_torch.core import hnsw

    c = hnsw.BEAM_COUNTERS
    return {"beam_calls": c["calls"] / n_batches, "lanes": c["lanes"] / n_batches,
            "level0_iterations": c["iterations"] / n_batches,
            "level0_lane_iterations": c["lane_iterations"] / n_batches,
            "upper_steps": c["upper_steps"] / n_batches, "syncs": c["syncs"] / n_batches}


def same_graphs(a, b) -> bool:
    """Every partition's frozen graph equal, array for array."""
    if set(a.partitions) != set(b.partitions):
        return False
    for sg, p in a.partitions.items():
        q = b.partitions[sg]
        if p.kind != q.kind:
            return False
        if p.kind == "hnsw":
            fa, fb = p.frozen, q.frozen
            if fa.entry != fb.entry or not all(
                    np.array_equal(getattr(fa, k), getattr(fb, k))
                    for k in ("vectors", "levels", "adj0", "upper_adj", "keys")):
                return False
    return True


def phase_pool_invariance(corpus, n: int = 16_000) -> dict:
    """The process-pool build after CUDA is initialized: ``workers=8`` and
    ``workers=0`` give the same frozen graphs (2 shards x 4 RH segments of
    the first ``n`` rows, the paper cell's graph settings)."""
    from repro_torch.core import LannsConfig, LannsIndex

    cfg = LannsConfig(num_shards=2, num_segments=4, segmenter="rh", alpha=0.15, engine="hnsw")
    workers = min(8, os.cpu_count() or 1)
    t0 = time.perf_counter()
    pooled = LannsIndex(cfg).build(corpus[:n], workers=workers)
    pool_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    serial = LannsIndex(cfg).build(corpus[:n], workers=0)
    serial_s = time.perf_counter() - t0
    equal = same_graphs(pooled, serial)
    rec = {"n": n, "workers": workers, "pool_build_s": pool_s, "serial_build_s": serial_s,
           "graphs_equal": equal}
    if not equal:
        raise AssertionError(f"pool invariance: workers={workers} graphs differ from workers=0")
    return rec


def phase_paper_hnsw(corpus, queries, gt_i, scan_ids, batch: int = 1024, topk: int = 100) -> dict:
    """3c: the paper cell with the HNSW engine at LannsConfig's defaults."""
    from repro_torch.convert import index_from_numpy_state, index_numpy_state
    from repro_torch.core import LannsConfig, LannsIndex, brute_force_topk, hnsw, recall_at_k, recall_table
    from repro_torch.kernels import ops

    pool = phase_pool_invariance(corpus)
    cfg = LannsConfig(num_shards=2, num_segments=4, segmenter="rh", alpha=0.15, engine="hnsw",
                      metric="l2")
    workers = min(8, os.cpu_count() or 1)
    idx = LannsIndex(cfg)
    t0 = time.perf_counter()
    idx.build(corpus, workers=workers)
    build_s = time.perf_counter() - t0
    resident = idx.hnsw_resident_bytes()
    batches = [queries[s: s + batch] for s in range(0, len(queries), batch)]
    idx.query(batches[0], topk)  # warm-up: allocator, cuBLAS handles

    ops.reset_launches()
    hnsw.reset_beam_counters()
    d_all, i_all, query_s, lat = timed_batches(idx, batches, topk)
    beam = beam_per_batch(len(batches))
    if any(ops.KERNEL_LAUNCHES.values()):
        raise AssertionError(f"paper hnsw: the beam launched {dict(ops.KERNEL_LAUNCHES)}")
    check_results(d_all, i_all, len(queries), topk, len(corpus), "paper hnsw")
    split = stage_split(idx, batches[:8], topk)
    split["beam"] = split.pop("candidates")
    rec = recall_table(i_all, gt_i, (1, 10, 100))
    rel_scan = recall_at_k(i_all, scan_ids, topk)

    # the ef sweep over 2,048 queries, against a ground truth recomputed
    # here through K1 (it must equal phase 3's)
    n_sw = 2 * batch
    ops.reset_launches()
    _, gt_sw = brute_force_topk(queries[:n_sw], corpus, topk)
    k1_launches = ops.KERNEL_LAUNCHES["distance_topk"]
    by_shape = shape_launches()
    if k1_launches <= 0 or not np.array_equal(gt_sw, gt_i[:n_sw]):
        raise AssertionError("paper hnsw: the K1 ground truth differs from phase 3's")
    sweep = []
    for ef in (64, 100, 200):
        idx.query(batches[0], topk, ef=ef)  # warm-up: the allocator after K1's buffers
        hnsw.reset_beam_counters()
        _, i_sw, s_sw, lat_sw = timed_batches(idx, batches[:2], topk, ef=ef)
        sweep.append({"ef": ef, "qps": n_sw / s_sw, "p50_ms": float(np.percentile(lat_sw, 50)),
                      "recall_at_100": recall_at_k(i_sw, gt_sw, topk),
                      "level0_iterations_per_batch": hnsw.BEAM_COUNTERS["iterations"] / 2})

    # the same frozen graphs on the CPU, carried across (not rebuilt)
    state = index_numpy_state(idx)
    cpu = index_from_numpy_state(*state, device="cpu")
    n_cpu = 256
    _, i_cpu = cpu.query(queries[:n_cpu], topk)
    ov = overlap(i_all[:n_cpu], i_cpu)
    sizes = [p.size for p in idx.partitions.values()]
    emit({"phase": "paper_hnsw", "n": len(corpus), "d": corpus.shape[1], "queries": len(queries),
          "config": "2 shards x 4 RH segments, alpha 0.15, hnsw (M 16, ef_construction 100, "
                    "ef_search 100), l2",
          "topk": topk, "batch": batch, "workers": workers, "build_s": build_s,
          "build_stats": build_split(idx),
          "per_partition_build_s": idx.build_stats["per_partition_seconds_summary"],
          "partition_rows_min_max": [min(sizes), max(sizes)],
          "pool_invariance": pool,
          "n_pad": idx._hnsw_stack()["n_pad"], "l_pad": idx._hnsw_stack()["l_pad"],
          "resident_device_bytes": resident,
          "qps": len(queries) / query_s,
          "p50_ms": float(np.percentile(lat, 50)), "p99_ms": float(np.percentile(lat, 99)),
          "batches_timed": len(lat), "beam_per_batch": beam, "split_ms": split,
          "recall": {f"R@{k}": v for k, v in rec.items()},
          "recall_rel_scan_at_100": rel_scan, "ef_sweep_2048q": sweep,
          "cpu_overlap_256": ov})
    if ov < 0.99:
        raise AssertionError(f"hnsw GPU vs CPU id-set overlap {ov} < 0.99")
    if rec[100] < 0.5:
        raise AssertionError(f"hnsw recall@100 {rec[100]} is implausibly low")
    return {"launches": k1_launches, "by_shape": by_shape, "state": state, "ids": i_all,
            "index": idx,
            "build_s": build_s, "footprint": footprint_record(idx, "fp32_hnsw", resident)}


def phase_paper_hnsw_q8(state, queries, gt_i, hnsw_ids, n_corpus: int, batch: int = 1024,
                        topk: int = 100) -> dict:
    """3d: 3c's graphs carried into a q8 index (quantized beam, exact
    re-rank on the card)."""
    import dataclasses

    from repro_torch.convert import index_from_numpy_state
    from repro_torch.core import LannsConfig, hnsw, recall_at_k, recall_table
    from repro_torch.kernels import ops

    config, tree, parts, mips = state
    cfg = dataclasses.replace(LannsConfig(**config), quantized="q8", rerank_factor=2,
                              rerank_store="auto")
    t0 = time.perf_counter()
    idx = index_from_numpy_state(dataclasses.asdict(cfg), tree, parts, mips)
    stack = idx._hnsw_stack(quantized=True)
    torch.cuda.synchronize()
    carry_s = time.perf_counter() - t0
    batches = [queries[s: s + batch] for s in range(0, len(queries), batch)]
    idx.query(batches[0], topk)  # warm-up: uploads the exact store

    ops.reset_launches()
    hnsw.reset_beam_counters()
    d_all, i_all, query_s, lat = timed_batches(idx, batches, topk)
    beam = beam_per_batch(len(batches))
    if any(ops.KERNEL_LAUNCHES.values()):
        raise AssertionError(f"paper hnsw q8: the beam launched {dict(ops.KERNEL_LAUNCHES)}")
    check_results(d_all, i_all, len(queries), topk, n_corpus, "paper hnsw q8")
    split = stage_split(idx, batches[:8], topk)
    split["beam"] = split.pop("stage1")  # the candidates stage is the beam + the re-rank
    rec = recall_table(i_all, gt_i, (1, 10, 100))
    rel = recall_at_k(i_all, hnsw_ids, topk)

    cpu = index_from_numpy_state(dataclasses.asdict(cfg), tree, parts, mips, device="cpu")
    n_cpu = 256
    _, i_cpu = cpu.query(queries[:n_cpu], topk)
    ov = overlap(i_all[:n_cpu], i_cpu)
    resident = idx.hnsw_resident_bytes()
    emit({"phase": "paper_hnsw_q8", "queries": len(queries),
          "config": "3c's graphs, q8 beam, rerank_factor 2, rerank_store auto "
                    f"({stack['store_mode']})",
          "topk": topk, "batch": batch, "carry_and_encode_s": carry_s,
          "resident_device_bytes": resident,
          "exact_store_device_bytes": sum(st.device_nbytes() for st in stack["stores"]),
          "qps": len(queries) / query_s,
          "p50_ms": float(np.percentile(lat, 50)), "p99_ms": float(np.percentile(lat, 99)),
          "beam_per_batch": beam, "split_ms": split,
          "recall": {f"R@{k}": v for k, v in rec.items()},
          "recall_rel_hnsw_fp32_at_100": rel, "cpu_overlap_256": ov})
    if rel < 0.95:
        raise AssertionError(f"q8 hnsw recall relative to fp32 hnsw {rel} < 0.95")
    if ov < 0.99:
        raise AssertionError(f"q8 hnsw GPU vs CPU id-set overlap {ov} < 0.99")
    return {"recall_rel": rel, "index": idx, "ids": i_all,
            "footprint": footprint_record(idx, "q8_hnsw", resident)}


def dir_bytes(root: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(root)
               for f in files)


def query_all(idx, queries, batch: int = 1024, topk: int = 100):
    """(dists, ids) of every query, in batches of ``batch``."""
    out = [idx.query(queries[s: s + batch], topk) for s in range(0, len(queries), batch)]
    return np.concatenate([d for d, _ in out]), np.concatenate([i for _, i in out])


def require_equal_ids(ids, want, label: str) -> float:
    """Id equality (the share of equal entries); anything below 1.0 fails."""
    eq = float(np.mean(ids == want)) if ids.shape == want.shape else 0.0
    if eq != 1.0:
        raise AssertionError(f"{label}: id equality {eq} != 1.0")
    return eq


def save_and_load(idx, label: str, workdir: str):
    """Save ``idx`` under a fresh directory of ``workdir``, load it on the
    card; (loaded index, artifact dir, record)."""
    from repro_torch.core import LannsIndex

    root = os.path.join(workdir, label)
    t0 = time.perf_counter()
    idx.save(root)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = LannsIndex.load(root)  # ends with its one upload and a sync
    load_s = time.perf_counter() - t0
    if loaded.device.type != "cuda":
        raise AssertionError(f"{label}: loaded on {loaded.device}")
    return loaded, root, {"artifact_bytes": dir_bytes(root), "files": len(os.listdir(root)),
                          "save_s": save_s, "load_s": load_s}


def served_equal(idx, queries, topk: int = 100, max_batch: int = 1024, tel=None) -> dict:
    """Serve ``queries`` through ``AsyncAnnFrontend`` and hold every request
    against ``index.query`` (telemetry detached) on its formed batch: ids
    and distances equal."""
    from repro_torch.serve import AsyncAnnFrontend

    with AsyncAnnFrontend(idx, topk=topk, max_batch=max_batch, max_wait_ms=2.0,
                          telemetry=tel) as fe:
        reqs = [fe.submit(q) for q in queries]
        if not all(r.wait(120.0) for r in reqs):
            raise AssertionError("served_equal: a request did not complete")
    done = fe.completed
    if len(done) != len(queries) or not all(r.done for r in done):
        raise AssertionError(f"served_equal: {len(done)} of {len(queries)} completed")
    prev = idx.telemetry
    idx.attach_telemetry(None)
    sizes, pos = [], 0
    try:
        while pos < len(done):
            batch = done[pos: pos + done[pos].batch_size]
            d, i = idx.query(np.stack([r.query for r in batch]), topk)
            if not (np.array_equal(np.stack([r.ids for r in batch]), i)
                    and np.array_equal(np.stack([r.dists for r in batch]), d)):
                raise AssertionError(f"served_equal: batch at {pos} differs from index.query")
            sizes.append(len(batch))
            pos += len(batch)
    finally:
        idx.attach_telemetry(prev)
    return {"requests": len(done), "formed_batches": sizes, "equal": True}


def load_point_record(res) -> dict:
    keys = ("offered_qps", "concurrency", "duration_s", "completed", "achieved_qps", "p50_ms",
            "p99_ms", "mean_ms", "mean_queue_ms", "mean_exec_ms", "mean_batch", "mean_recall",
            "slo_attainment", "degraded")
    row = res.row()
    rec = {k: row[k] for k in keys}
    rec["stage_ms"] = {st: {k: pct[k] for k in ("p50_ms", "p99_ms", "mean_ms")}
                       for st, pct in row["stage_breakdown"].items()}
    return rec


def serve_online(idx, label: str, queries, gt_i, *, topk: int = 100, max_batch: int = 1024,
                 sat_s: float = 3.0, point_s: float = 7.0, ab_s: float = 0.0,
                 ladder=(80, 64)) -> dict:
    """(e) for one loaded index: the closed-loop saturation, Poisson points
    at 0.5x and 0.9x of it, 256 served requests against ``index.query``,
    and (``ab_s`` > 0) a controller A/B at 0.9x."""
    from repro_torch.analysis import RetraceSentinel
    from repro_torch.obs import Telemetry
    from repro_torch.serve import measure_saturation_qps, run_controller_ab, run_load_point

    tel = Telemetry(sentinel=RetraceSentinel(idx.device))
    kw = {"topk": topk, "max_batch": max_batch, "max_wait_ms": 2.0, "telemetry": tel}
    sat = measure_saturation_qps(idx, queries, duration_s=sat_s, **kw)
    points = [run_load_point(idx, queries, process="poisson", duration_s=point_s, seed=pi,
                             rate_qps=frac * sat.achieved_qps, gt_ids=gt_i, **kw)
              for pi, frac in enumerate((0.5, 0.9))]
    rec = {"saturation": load_point_record(sat),
           "poisson_0.5x": load_point_record(points[0]),
           "poisson_0.9x": load_point_record(points[1]),
           "served_equal_256": served_equal(idx, queries[:256], topk, max_batch, tel)}
    for res in (sat, *points):
        if res.cancelled or res.completed != res.submitted or not res.completed:
            raise AssertionError(f"{label}: a load point lost requests: {res.row()}")
    if ab_s > 0:
        # the SLO is one mean batch execution of the 0.9x Poisson point: a
        # request that has queued that long at batch formation is late, and
        # the controller degrades its ef.  (The reference bench's rule,
        # twice the full-batch service time at saturation, is ~900 ms here,
        # where the closed loop is bound by its client threads; and with
        # the 0.9x point's p50, ~200 ms, no request queued long enough to
        # be degraded.)
        slo_ms = points[1].mean_exec_ms
        off, on, ctrl = run_controller_ab(
            idx, queries, rate_qps=0.9 * sat.achieved_qps, slo_ms=slo_ms, ef_ladder=ladder,
            process="mmpp", duration_s=ab_s, gt_ids=gt_i, **kw)
        rec["controller_ab"] = {"process": "mmpp", "rate_qps": 0.9 * sat.achieved_qps,
                                "slo_ms": slo_ms, "ef_ladder": list(ladder),
                                "off": load_point_record(off), "on": load_point_record(on),
                                "controller": ctrl.snapshot()}
    rec["retraces_seen_by_telemetry"] = {
        fn: tel.retraces_total.labels(fn).value
        for fn in ("kernel_library_loads", "allocator_segments")}
    return rec


def submitter(gap_s: float, stop, sink: list) -> None:
    """A load generator's open loop without the front end: sleep one
    arrival gap, then do a submit's worth of Python (an array, a
    ``threading.Event``, a list append)."""
    import threading

    q = np.zeros(128, np.float32)
    t_next = time.perf_counter() + gap_s
    while not stop.is_set():
        now = time.perf_counter()
        if now >= t_next:
            sink.append((np.asarray(q, np.float32), now, threading.Event()))
            t_next += gap_s
        else:
            time.sleep(min(t_next - now, 2e-3))


def beam_contention(idx, queries, topk: int = 100, reps: int = 5) -> dict:
    """(f): mean ms of one ``index.query`` on the loaded HNSW index, for a
    small online batch (180 queries) and a full one (1,024), alone and
    while ``submitter`` wakes 1,000 / 2,500 / 10,000 times a second.  Every
    torch op of the beam releases and retakes the GIL, so this is what a
    load generator's thread costs the batcher."""
    import threading

    def mean_ms(qb) -> float:
        idx.query(qb, topk)
        t0 = time.perf_counter()
        for _ in range(reps):
            idx.query(qb, topk)  # numpy out: synchronized
        return 1e3 * (time.perf_counter() - t0) / reps

    out = {}
    for b in (180, 1024):
        qb = queries[:b]
        row = {"alone_ms": mean_ms(qb)}
        for rate in (1000, 2500, 10000):
            stop, sink = threading.Event(), []
            th = threading.Thread(target=submitter, args=(1.0 / rate, stop, sink), daemon=True)
            th.start()
            try:
                row[f"with_{rate}_per_s_ms"] = mean_ms(qb)
            finally:
                stop.set()
                th.join(10.0)
        row["alone_again_ms"] = mean_ms(qb)
        out[f"batch_{b}"] = row
    return out


def phase_persist_serve(scan_idx, hnsw_idx, hnsw_q8_idx, corpus, queries, gt_i, scan_ids,
                        hnsw_ids, hnsw_q8_ids, hnsw_build_s: float, *, batch: int = 1024,
                        topk: int = 100, sat_s: float = 3.0, point_s: float = 7.0,
                        ab_s: float = 4.0) -> dict:
    """3e: persist and serve, on phase 3's data and 3c's / 3d's graphs
    (nothing is built at 1M again).  (a) save 3c's index and load it on the
    card: 3c's ids, 3c's resident bytes; (b) resume a fresh build from that
    artifact: 0 partitions built, 3c's ids; (c) 3d's q8 index round trip:
    codes loaded, not re-encoded, 3d's ids; (d) phase 3's scan index round
    trip: its ids; (e) the loaded HNSW and scan indexes served online
    through ``AsyncAnnFrontend`` with telemetry after ``warm_traces``, with
    no kernel library built or loaded in the serving window; (f) the loaded
    HNSW index's query time beside a submitting thread."""
    import shutil
    import tempfile

    from repro_torch.analysis import RetraceSentinel
    from repro_torch.core import LannsIndex
    from repro_torch.core import lanns as lanns_module
    from repro_torch.kernels import ops

    ops.reset_launches()
    (ROOT / "build").mkdir(exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="persist_3e_", dir=ROOT / "build")
    try:
        # (a) save and load 3c's index
        hnsw, root, a = save_and_load(hnsw_idx, "hnsw", workdir)
        a["hnsw_build_s_3c"] = hnsw_build_s
        a["resident_device_bytes"] = hnsw.hnsw_resident_bytes()
        if a["resident_device_bytes"] != hnsw_idx.hnsw_resident_bytes():
            raise AssertionError(f"3e (a): resident bytes {a['resident_device_bytes']} != 3c's "
                                 f"{hnsw_idx.hnsw_resident_bytes()}")
        a["id_equality_3c"] = require_equal_ids(query_all(hnsw, queries, batch, topk)[1],
                                                hnsw_ids, "3e (a) loaded hnsw")
        emit({"phase": "persist_serve", "step": "a_save_load_hnsw", **a})

        # (b) resume from that artifact: nothing built
        fresh = LannsIndex(hnsw_idx.config)
        t0 = time.perf_counter()
        fresh.build(corpus, resume_dir=root)
        b = {"resume_s": time.perf_counter() - t0,
             "partitions_built": len(fresh.build_stats["per_partition_seconds"]),
             "partitions": len(fresh.partitions)}
        if b["partitions_built"] != 0:
            raise AssertionError(f"3e (b): resume built {b['partitions_built']} partitions")
        b["id_equality_3c"] = require_equal_ids(query_all(fresh, queries, batch, topk)[1],
                                                hnsw_ids, "3e (b) resumed hnsw")
        emit({"phase": "persist_serve", "step": "b_resume", **b})
        del fresh
        shutil.rmtree(root)

        # (c) q8 round trip: the saved codes are loaded, not re-encoded
        real, calls = lanns_module.quantize_q8, []
        lanns_module.quantize_q8 = lambda *args, **kw: calls.append(1) or real(*args, **kw)
        try:
            q8, root, c = save_and_load(hnsw_q8_idx, "hnsw_q8", workdir)
        finally:
            lanns_module.quantize_q8 = real
        c["re_encodes"] = len(calls)
        if calls or not all(np.array_equal(p.q8.codes, hnsw_q8_idx.partitions[sg].q8.codes)
                            for sg, p in q8.partitions.items() if p.size):
            raise AssertionError(f"3e (c): q8 codes re-encoded ({len(calls)}) or changed")
        c["codes_equal"] = True
        c["resident_device_bytes"] = q8.hnsw_resident_bytes()
        c["id_equality_3d"] = require_equal_ids(query_all(q8, queries, batch, topk)[1],
                                                hnsw_q8_ids, "3e (c) loaded hnsw q8")
        emit({"phase": "persist_serve", "step": "c_q8_round_trip", **c})
        del q8
        shutil.rmtree(root)

        # (d) fp32 scan round trip (K1)
        scan, root, dd = save_and_load(scan_idx, "scan", workdir)
        dd["id_equality_3"] = require_equal_ids(query_all(scan, queries, batch, topk)[1],
                                                scan_ids, "3e (d) loaded scan")
        emit({"phase": "persist_serve", "step": "d_scan_round_trip", **dd})
        shutil.rmtree(root)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    # (e) online serving of the loaded indexes
    warm = {}
    ladder = (80, 64)
    for label, idx, knobs in (("hnsw", hnsw, [(topk, ef) for ef in ladder]),
                              ("scan", scan, None)):
        t0 = time.perf_counter()
        idx.warm_traces(batch, topk, knobs=knobs)
        warm[label] = time.perf_counter() - t0
    window = RetraceSentinel(torch.device("cuda"))
    for label, idx, ab in (("hnsw", hnsw, ab_s), ("scan", scan, 0.0)):
        emit({"phase": "persist_serve", "step": f"e_online_{label}", "max_batch": batch,
              "topk": topk, **serve_online(idx, label, queries, gt_i, topk=topk,
                                           max_batch=batch, sat_s=sat_s, point_s=point_s,
                                           ab_s=ab, ladder=ladder)})
    stalls = window.deltas()
    k1 = ops.KERNEL_LAUNCHES["distance_topk"]
    by_shape = shape_launches()
    emit({"phase": "persist_serve", "step": "e_window", "warm_traces_s": warm,
          "time_to_serve_s": {"hnsw": a["load_s"] + warm["hnsw"],
                              "scan": dd["load_s"] + warm["scan"]},
          "serving_window": {"kernel_library_loads": stalls["kernel_library_loads"],
                             "allocator_segments_delta": stalls["allocator_segments"]},
          "k1_launches_3e": k1, "k2_launches_3e": ops.KERNEL_LAUNCHES["distance_topk_q8"]})
    if stalls["kernel_library_loads"]:
        raise AssertionError(f"3e (e): {stalls['kernel_library_loads']} kernel libraries built "
                             "or loaded in the serving window")
    emit({"phase": "persist_serve", "step": "f_beam_contention",
          **beam_contention(hnsw, queries, topk)})
    if k1 <= 0:
        raise AssertionError("3e: the scan served without launching K1")
    return {"launches": k1, "by_shape": by_shape, "scan_index": scan}


def save_device_index(index, root: str) -> None:
    """``index``'s arrays as ``.npy`` files under ``root`` (read back by
    each rank with ``load_device_index``, memory-mapped copy-on-write: a
    rank reads its own shard and nothing is pickled to it)."""
    os.makedirs(root)
    for name in ("corpus", "ids", "norms"):
        np.save(os.path.join(root, f"{name}.npy"), getattr(index, name))
    if index.scale is not None:
        np.save(os.path.join(root, "scale.npy"), index.scale)
    if index.tree is not None:
        np.savez(os.path.join(root, "tree.npz"), **index.tree)


def load_device_index(root: str, config):
    from repro_torch.serve.retrieval import DeviceIndex

    arrays = {name: np.load(os.path.join(root, f"{name}.npy"), mmap_mode="c")
              for name in ("corpus", "ids", "norms")}
    scale_path, tree_path = os.path.join(root, "scale.npy"), os.path.join(root, "tree.npz")
    tree = None
    if os.path.exists(tree_path):
        with np.load(tree_path) as f:
            tree = {k: f[k] for k in f.files}
        tree["depth"] = int(tree["depth"])
    scale = np.load(scale_path) if os.path.exists(scale_path) else None
    return DeviceIndex(tree=tree, config=config, scale=scale, **arrays)


def serve_step_rank(mesh, jobs, queries, batch: int, topk: int) -> dict:
    """Rank body of 3f: each job (label, index dir, config, serve kwargs)
    through ``make_serve_fn`` on this rank's shard and rows, in batches of
    ``batch``: one untimed batch first on the card, then the K1 count set
    to 0 and every batch timed (host clock over the loop; per batch, CUDA
    events on the card, the host clock on the CPU).  Returns, per job, this rank's outputs, times,
    overflow, K1 launches and resident bytes."""
    from repro_torch.common.utils import resolve_device
    from repro_torch.kernels import ops
    from repro_torch.serve.retrieval import make_serve_fn, shard_arrays

    dev = resolve_device(mesh.device_type)
    out = {}
    for label, root, config, kw in jobs:
        serve_fn, info = make_serve_fn(mesh, config, topk=topk, batch_per_device=batch, **kw)
        arrays = shard_arrays(load_device_index(root, config), info["shard"], dev)
        resident = sum(t.numel() * t.element_size() for t in
                       (arrays["corpus"], arrays["ids"], arrays["norms"], arrays["scale"])
                       if t is not None)
        blocks, b = info["query_blocks"], info["query_block"]

        def rows(qb):  # this rank's rows of one global batch
            n = len(qb) // blocks
            return torch.from_numpy(qb[b * n: (b + 1) * n]).to(dev)

        batches = [queries[s: s + batch] for s in range(0, len(queries), batch)]
        if dev.type == "cuda":
            serve_fn(rows(batches[0]), **arrays)
            torch.cuda.synchronize()
        ops.reset_launches()
        dists, ids, lat, ovf = [], [], [], 0
        if dev.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
        t0 = time.perf_counter()
        for qb in batches:
            t1 = time.perf_counter()
            if dev.type == "cuda":
                start.record()
            d, i, o = serve_fn(rows(qb), **arrays)
            if dev.type == "cuda":
                end.record()
                end.synchronize()
                lat.append(start.elapsed_time(end))
            else:
                lat.append(1e3 * (time.perf_counter() - t1))
            dists.append(d.cpu().numpy())
            ids.append(i.cpu().numpy())
            ovf += int(o)
        seconds = time.perf_counter() - t0
        out[label] = {"dists": np.concatenate(dists), "ids": np.concatenate(ids),
                      "seconds": seconds, "batch_ms": lat, "overflow": ovf,
                      "k1_launches": ops.KERNEL_LAUNCHES["distance_topk"],
                      "k1_by_shape": shape_launches(),
                      "resident_bytes": resident, "per_shard_topk": info["per_shard_topk"],
                      "capacity": info["capacity"], "shard": info["shard"]}
        del arrays
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def phase_serve_step(corpus, queries, gt_i, batch: int = 1024, topk: int = 100,
                     n_cpu: int = 256) -> dict:
    """3f: the distributed serve step (``serve.retrieval.make_serve_fn``)
    on phase 3's data, in worlds of spawned ranks (``launch.mesh.run_world``).
    (a) one rank, NCCL, mesh (data 1, model 1): full mode over 1 x 4 RH
    segments against phase 3's K1 ground truth; routed mode over 1 x 8 RH
    segments (alpha 0.15) in float32, bfloat16 and int8.  (b) the paper
    cell's 2 shards x 4 RH segments, routed, float32, on two ranks on the one
    card over gloo, mesh (data 1, model 2).  Each card world's routed f32
    ids against the same world on CPU tensors for ``n_cpu`` queries."""
    import shutil
    import tempfile

    from repro_torch.core import LannsConfig, recall_table
    from repro_torch.launch.mesh import run_world
    from repro_torch.serve.retrieval import build_device_index

    axes = ("data", "model")
    configs = {
        "full": (LannsConfig(num_shards=1, num_segments=4, segmenter="rh", engine="scan"),
                 "float32", {"mode": "full"}),
        "routed": (LannsConfig(num_shards=1, num_segments=8, segmenter="rh", alpha=0.15,
                               engine="scan"), "float32", {"mode": "routed"}),
        "routed_bf16": (LannsConfig(num_shards=1, num_segments=8, segmenter="rh", alpha=0.15,
                                    engine="scan"), "bfloat16", {"mode": "routed"}),
        "routed_int8": (LannsConfig(num_shards=1, num_segments=8, segmenter="rh", alpha=0.15,
                                    engine="scan"), "int8", {"mode": "routed"}),
        "paper": (LannsConfig(num_shards=2, num_segments=4, segmenter="rh", alpha=0.15,
                              engine="scan"), "float32", {"mode": "routed"}),
    }
    workdir = tempfile.mkdtemp(prefix="serve_step_3f_", dir=ROOT / "build")
    try:
        jobs, build_s = {}, {}
        for label, (cfg, dtype, kw) in configs.items():
            t0 = time.perf_counter()
            index = build_device_index(corpus, cfg, corpus_dtype=dtype)
            build_s[label] = time.perf_counter() - t0
            save_device_index(index, os.path.join(workdir, label))
            jobs[label] = (label, os.path.join(workdir, label), cfg, kw)
            del index
        world_s = {}

        def world(name, shape, labels, qs, **kw):
            t0 = time.perf_counter()
            outs = run_world(serve_step_rank, shape, axes,
                             ([jobs[lb] for lb in labels], qs, batch, topk), timeout=900, **kw)
            world_s[name] = time.perf_counter() - t0
            return outs

        a = world("a", (1, 1), ["full", "routed", "routed_bf16", "routed_int8"], queries)[0]
        a_cpu = world("a_cpu", (1, 1), ["routed"], queries[:n_cpu], device="cpu")[0]
        print("3f (b): two ranks share the one card over gloo (NCCL refuses two ranks on "
              "one GPU); this world measures the serve step's code, not NCCL across cards",
              flush=True)
        b = world("b", (1, 2), ["paper"], queries, backend="gloo")
        b_cpu = world("b_cpu", (1, 2), ["paper"], queries[:n_cpu], device="cpu")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    n_batches = -(-len(queries) // batch)
    n = len(corpus)

    def summary(r, label):
        check_results(r["dists"], r["ids"], len(queries), topk, n, f"3f {label}")
        lat = np.asarray(r["batch_ms"])
        return {"qps": len(queries) / r["seconds"], "p50_ms": float(np.percentile(lat, 50)),
                "p99_ms": float(np.percentile(lat, 99)), "overflow": r["overflow"],
                "k1_launches_per_batch": r["k1_launches"] / n_batches,
                "resident_bytes": r["resident_bytes"], "capacity": r["capacity"],
                "per_shard_topk": r["per_shard_topk"]}

    full = summary(a["full"], "full")
    full["gt_overlap"] = overlap(a["full"]["ids"], gt_i)
    routed = summary(a["routed"], "routed")
    routed["recall"] = {f"R@{k}": v for k, v in recall_table(a["routed"]["ids"], gt_i,
                                                              (1, 10, 100)).items()}
    routed["cpu_overlap"] = overlap(a["routed"]["ids"][:n_cpu], a_cpu["routed"]["ids"])
    quant = {}
    for label in ("routed_bf16", "routed_int8"):
        quant[label] = summary(a[label], label)
        quant[label]["recall_rel_f32"] = overlap(a[label]["ids"], a["routed"]["ids"])
        quant[label]["recall"] = {f"R@{k}": v for k, v in recall_table(
            a[label]["ids"], gt_i, (1, 10, 100)).items()}
    emit({"phase": "serve_step", "step": "a", "world": "1 rank, nccl, mesh (data 1, model 1)",
          "batch": batch, "topk": topk, "build_s": build_s, "world_s": world_s,
          "full": full, "routed": routed, **quant})
    b0 = b[0]["paper"]
    for r in b[1:]:  # every rank holds the broker's answer for the batch
        if not np.array_equal(r["paper"]["ids"], b0["ids"]):
            raise AssertionError("3f (b): the ranks' merged ids differ")
    paper = summary(b0, "paper")
    paper["resident_bytes"] = [r["paper"]["resident_bytes"] for r in b]
    paper["recall"] = {f"R@{k}": v for k, v in recall_table(b0["ids"], gt_i,
                                                             (1, 10, 100)).items()}
    paper["cpu_overlap"] = overlap(b0["ids"][:n_cpu], b_cpu[0]["paper"]["ids"])
    paper["k1_launches_per_rank"] = [r["paper"]["k1_launches"] for r in b]
    emit({"phase": "serve_step", "step": "b",
          "world": "2 ranks on one card, gloo, mesh (data 1, model 2)",
          "config": "2 shards x 4 RH segments, alpha 0.15, routed, f32", **paper})
    if full["gt_overlap"] < 0.999:
        raise AssertionError(f"3f full mode vs K1 ground truth overlap {full['gt_overlap']}")
    if routed["recall"]["R@100"] < 0.5 or paper["recall"]["R@100"] < 0.5:
        raise AssertionError("3f: routed recall@100 is implausibly low")
    for label, ov in (("a routed", routed["cpu_overlap"]), ("b", paper["cpu_overlap"])):
        if ov < 0.999:
            raise AssertionError(f"3f {label}: card vs CPU id-set overlap {ov} < 0.999")
    launches = [(a["full"]["k1_launches"], 4), (a["routed"]["k1_launches"], 8)]
    launches += [(r["paper"]["k1_launches"], 4) for r in b]
    for got, segments in launches:  # K1 in every f32 segment scan of every batch
        if got != segments * n_batches:
            raise AssertionError(f"3f: K1 launched {got} times for {segments} segments x "
                                 f"{n_batches} batches")
    by_shape = add_shapes(a["full"]["k1_by_shape"], a["routed"]["k1_by_shape"],
                          *(r["paper"]["k1_by_shape"] for r in b))
    return {"launches": sum(got for got, _ in launches), "by_shape": by_shape}


def phase_beam_profile(state, batch_queries: np.ndarray, topk: int = 100) -> dict:
    """7: one batch of 3c and one of 3d (the same graphs carried in again)
    under ``torch.profiler``: kernel launches, device busy time, idle share
    and the top kernels.  It runs last because a profiler session slows the
    kernel launches of the rest of the process, and the beam and the LM
    decode step are launch-bound."""
    import dataclasses

    from repro_torch.convert import index_from_numpy_state
    from repro_torch.core import LannsConfig

    config, tree, parts, mips = state
    out = {}
    for quantized in ("none", "q8"):
        cfg = dataclasses.replace(LannsConfig(**config), quantized=quantized)
        idx = index_from_numpy_state(dataclasses.asdict(cfg), tree, parts, mips)
        idx.query(batch_queries, topk)  # warm-up: uploads, allocator
        out["paper_hnsw" if quantized == "none" else "paper_hnsw_q8"] = device_profile(
            lambda: idx.query(batch_queries, topk))
        del idx
    emit({"phase": "beam_profile", "batch": len(batch_queries), "topk": topk, **out})
    return out


def host_available_bytes() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("MemAvailable not in /proc/meminfo")


def sift_like_on_device(n, d, seed, center_seed, n_clusters, out: np.ndarray, chunk=1 << 20):
    """The sift_like mixture (unit-norm centers, 1/i spectrum, std 0.15)
    drawn on the card in float32 chunks into the host array ``out``."""
    spec = 1.0 / torch.arange(1, d + 1, dtype=torch.float32, device="cuda")
    spec = spec / spec.pow(2).mean().sqrt()
    g_c = torch.Generator(device="cuda").manual_seed(center_seed)
    centers = torch.randn(n_clusters, d, generator=g_c, device="cuda") * spec
    centers = centers / centers.norm(dim=1, keepdim=True)
    g = torch.Generator(device="cuda").manual_seed(seed)
    for s in range(0, n, chunk):
        m = min(chunk, n - s)
        a = torch.randint(0, n_clusters, (m,), generator=g, device="cuda")
        x = centers[a] + 0.15 * torch.randn(m, d, generator=g, device="cuda") * spec
        torch.from_numpy(out[s: s + m]).copy_(x)


def phase_deployment(n_full: int = 10_000_000, batch: int = 1024, topk: int = 100) -> dict:
    from repro_torch.core import LannsConfig, LannsIndex, brute_force_topk, recall_at_k
    from repro_torch.kernels import ops

    gc.collect()
    torch.cuda.empty_cache()
    d = 512
    n = n_full
    # host: the corpus plus one partition copy; card: the index plus the
    # brute-force copy of the corpus.  Halve n until both fit.
    free_dev, _ = torch.cuda.mem_get_info()
    while n * d * 4 * 1.3 > host_available_bytes() or n * d * 4 * 2.2 > free_dev:
        n //= 2
    t0 = time.perf_counter()
    nc = max(32, n // 300)
    corpus = np.empty((n, d), np.float32)
    sift_like_on_device(n, d, seed=0, center_seed=0, n_clusters=nc, out=corpus)
    n_q = 8 * batch
    queries = np.empty((n_q, d), np.float32)
    sift_like_on_device(n_q, d, seed=1, center_seed=0, n_clusters=nc, out=queries)
    gen_s = time.perf_counter() - t0

    cfg = LannsConfig(num_shards=8, num_segments=8, segmenter="rh", alpha=0.15,
                      engine="scan", metric="l2")
    idx = LannsIndex(cfg)
    t0 = time.perf_counter()
    idx.build(corpus)
    build_s = time.perf_counter() - t0
    resident = sum(p.vectors.numel() * 4 + p.keys.numel() * 8 for p in idx.partitions.values())
    batches = [queries[s: s + batch] for s in range(0, n_q, batch)]
    idx.query(batches[0], topk)  # warm-up

    ops.reset_launches()
    lat = []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(3):
        for qb in batches:
            start.record()
            d_b, i_b = idx.query(qb, topk)
            end.record()
            end.synchronize()
            lat.append(start.elapsed_time(end))
    check_results(d_b, i_b, batch, topk, n, "deployment")
    launches_query = ops.KERNEL_LAUNCHES["distance_topk"]
    by_shape = shape_launches()

    split = stage_split(idx, batches, topk)
    plan = idx._exec.plan(torch.from_numpy(batches[0]).cuda(), topk)
    g = int(np.argmax([s.numel() for s in plan.sels]))
    timing = time_kernel(
        plan.queries.index_select(0, plan.sels[g]).contiguous(),
        idx.partitions[(0, g)].vectors, plan.pstk, f"deployment: partition (0,{g}), first batch",
    )

    n_rec = 1000
    ops.reset_launches()
    _, i_r = idx.query(queries[:n_rec], topk)
    _, gt_i = brute_force_topk(queries[:n_rec], corpus, topk)
    launches = launches_query + ops.KERNEL_LAUNCHES["distance_topk"]
    by_shape = add_shapes(by_shape, shape_launches())
    if ops.KERNEL_LAUNCHES["distance_topk_q8"] != 0:
        raise AssertionError("the fp32 path launched K2")
    r100 = recall_at_k(i_r, gt_i, topk)
    lat = np.asarray(lat)
    emit({"phase": "deployment", "n": n, "d": d, "reduced": n != n_full,
          "config": "8 shards x 8 RH segments, alpha 0.15, scan, l2",
          "topk": topk, "batch": batch, "datagen_s": gen_s, "build_s": build_s,
          "build_stats": build_split(idx),
          "resident_bytes": resident,
          "partition_rows_min_max": [min(p.size for p in idx.partitions.values()),
                                     max(p.size for p in idx.partitions.values())],
          "qps": batch * len(lat) / (lat.sum() / 1e3),
          "p50_ms": float(np.percentile(lat, 50)), "p99_ms": float(np.percentile(lat, 99)),
          "batches_timed": len(lat), "split_ms": split,
          "k1_launches_per_batch": launches_query / len(lat),
          "recall_at_100_1000q": r100})
    if r100 < 0.5:
        raise AssertionError(f"deployment recall@100 {r100} is implausibly low")
    return {"launches": launches, "by_shape": by_shape, "timing": timing,
            "footprint": footprint_record(idx, "fp32_scan", resident),
            "data": (corpus, queries, gt_i, i_r, n_full)}


def phase_deployment_q8(corpus, queries, gt_i, fp32_ids, n_full: int, batch: int = 1024,
                        topk: int = 100) -> dict:
    from repro_torch.core import LannsConfig, LannsIndex, recall_at_k
    from repro_torch.kernels import ops

    gc.collect()
    torch.cuda.empty_cache()  # phase 4's fp32 index is gone
    n, d = corpus.shape
    cfg = LannsConfig(num_shards=8, num_segments=8, segmenter="rh", alpha=0.15,
                      engine="scan", metric="l2", quantized="q8", rerank_factor=2,
                      rerank_store="auto")
    idx = LannsIndex(cfg)
    t0 = time.perf_counter()
    idx.build(corpus)
    build_s = time.perf_counter() - t0
    ex = idx._q8_executor()
    batches = [queries[s: s + batch] for s in range(0, len(queries), batch)]
    t0 = time.perf_counter()
    idx.query(batches[0], topk)  # warm-up: uploads the exact store
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    ops.reset_launches()
    lat = []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(3):
        for qb in batches:
            start.record()
            d_b, i_b = idx.query(qb, topk)
            end.record()
            end.synchronize()
            lat.append(start.elapsed_time(end))
    launches_timed = ops.KERNEL_LAUNCHES["distance_topk_q8"]
    by_shape = shape_launches("distance_topk_q8")
    if launches_timed <= 0 or ops.KERNEL_LAUNCHES["distance_topk"] != 0:
        raise AssertionError(f"deployment q8: launches {dict(ops.KERNEL_LAUNCHES)}")
    check_results(d_b, i_b, batch, topk, n, "deployment q8")
    split = stage_split(idx, batches, topk)

    # one batch with the exact store on the host (the footprint file's
    # placement), against the device store
    d_dev, i_dev = idx.query(batches[0], topk)
    ex.rerank_store = "host"
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d_host, i_host = idx.query(batches[0], topk)
        host_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        ex.rerank_store = "device"
    err, host_swaps = compare_topk(torch.from_numpy(d_host), torch.from_numpy(i_host),
                                   torch.from_numpy(d_dev), torch.from_numpy(i_dev),
                                   "deployment q8: host vs device store", tol=1e-4)

    plan = idx._exec.plan(torch.from_numpy(batches[0]).cuda(), topk)
    g = int(np.argmax([s.numel() for s in plan.sels]))
    timing = time_q8_kernel(ex.parts[(0, g)], plan.queries.index_select(0, plan.sels[g]),
                            cfg.rerank_factor * plan.pstk,
                            f"deployment q8: partition (0,{g}), first batch")

    n_rec = len(gt_i)
    ops.reset_launches()
    _, i_r = idx.query(queries[:n_rec], topk)
    launches = launches_timed + ops.KERNEL_LAUNCHES["distance_topk_q8"]
    by_shape = add_shapes(by_shape, shape_launches("distance_topk_q8"))
    r100 = recall_at_k(i_r, gt_i, topk)
    rel = recall_at_k(i_r, fp32_ids, topk)
    lat = np.asarray(lat)
    emit({"phase": "deployment_q8", "n": n, "d": d, "reduced": n != n_full,
          "config": "8 shards x 8 RH segments, alpha 0.15, scan, l2, q8, rerank_factor 2, "
                    f"rerank_store auto ({ex.rerank_store})",
          "topk": topk, "batch": batch, "build_s": build_s,
          "q8_encode_s": idx.build_stats["q8_encode_seconds"], "build_stats": build_split(idx),
          "warmup_query_s": warm_s,
          "resident_scan_bytes": ex.resident_bytes(),
          "exact_store_device_bytes": ex.exact_store_device_bytes(),
          "qps": batch * len(lat) / (lat.sum() / 1e3),
          "p50_ms": float(np.percentile(lat, 50)), "p99_ms": float(np.percentile(lat, 99)),
          "batches_timed": len(lat), "split_ms": split,
          "k2_launches_per_batch": launches_timed / len(lat),
          "host_store_batch_ms": host_ms, "host_vs_device_max_abs_err": err,
          "host_vs_device_tie_swaps": host_swaps,
          "recall_at_100_1000q": r100, "recall_rel_fp32_at_100_1000q": rel})
    if r100 < 0.5:
        raise AssertionError(f"deployment q8 recall@100 {r100} is implausibly low")
    return {"launches": launches, "by_shape": by_shape, "timing": timing,
            "footprint": footprint_record(idx, "q8_scan", ex.resident_bytes())}

# ------------------------------------------------------------ the checkers (3h)


def footprint_record(idx, mode: str, measured: int) -> dict:
    """A phase's resident device bytes and its index's own dims, for 3h
    (c) to hold against the footprint model."""
    from repro_torch.analysis.scalecheck import index_footprint_dims

    return {"mode": mode, "dims": index_footprint_dims(idx), "measured_bytes": int(measured)}


def phase_race_stress(scan_idx, queries, threads: int = 8, duration_s: float = 6.0,
                      seed: int = 0) -> dict:
    """3h (a): the seeded lifecycle churn of instrumented front ends over
    3e's loaded paper scan index, on the card, with phase 3's queries."""
    from repro_torch.analysis.runtime import race_stress
    from repro_torch.kernels import ops

    ops.reset_launches()
    t0 = time.perf_counter()
    report = race_stress(threads=threads, duration_s=duration_s, seed=seed, index=scan_idx,
                         queries=queries)
    seconds = time.perf_counter() - t0
    k1 = ops.KERNEL_LAUNCHES["distance_topk"]
    by_shape = shape_launches()
    rec = {"threads": threads, "duration_s": duration_s, "seed": seed, "seconds": seconds,
           "cycles": report.cycles_run, "submitted": report.submitted,
           "completed": report.completed, "cancelled": report.cancelled,
           "controller_ticks": report.retunes, "degrades": report.degraded,
           "lock_edges": sorted(f"{a}->{b}" for a, b in report.lock_edges),
           "lock_cycles": report.lock_cycles, "violations": report.violations[:20],
           "k1_launches": k1, "ok": report.ok}
    emit({"phase": "checkers", "step": "a_race_stress", **rec})
    if not report.ok:
        raise AssertionError(f"3h (a): race stress failed:\n{report.render()}")
    if k1 <= 0 or report.completed <= 0:
        raise AssertionError(f"3h (a): K1 launched {k1} times, {report.completed} completed")
    return {"launches": k1, "by_shape": by_shape}


def start_static_pass():
    """3h (b)'s ``--strict`` pass over the port, in a host process (it needs
    no card)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen([sys.executable, "-m", "repro_torch.analysis", "--strict"],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def finish_static_pass(proc) -> dict:
    """3h (b): the pass's exit code, its findings by code and its
    suppressions, read from the CLI's summary."""
    import re

    t0 = time.perf_counter()
    out, err = proc.communicate(timeout=300)
    summary = re.search(r"(\d+) finding\(s\), (\d+) suppressed", out)
    active = {m.group(1): int(m.group(2))
              for m in re.finditer(r"^  (LANNS\d+) \([\w-]+\): (\d+)$", out, re.M)}
    suppressed = {}
    for m in re.finditer(r"^  \S+:\d+: (LANNS\d+) -- ", out, re.M):
        suppressed[m.group(1)] = suppressed.get(m.group(1), 0) + 1
    rec = {"rc": proc.returncode, "wait_s": time.perf_counter() - t0,
           "findings": int(summary.group(1)) if summary else None,
           "findings_by_code": active,
           "suppressed": int(summary.group(2)) if summary else None,
           "suppressed_by_code": suppressed}
    emit({"phase": "checkers", "step": "b_static_pass", **rec})
    if proc.returncode != 0 or summary is None:
        raise AssertionError(f"3h (b): --strict exited {proc.returncode}:\n{out[-3000:]}"
                             f"\n{err[-2000:]}")
    return rec


def phase_footprint_calibration(records: dict) -> dict:
    """3h (c): the footprint model at each measured cell's own dims against
    the resident device bytes its phase measured; measured must not exceed
    predicted (the model is a bound)."""
    from repro_torch.analysis.scalecheck import footprint_report

    cells = {}
    for phase, rec in records.items():
        predicted = footprint_report(rec["dims"])["metrics"][
            f"footprint_{rec['mode']}_device_bytes"]
        cells[phase] = {**rec, "predicted_bytes": int(predicted),
                        "ratio": rec["measured_bytes"] / predicted}
    emit({"phase": "checkers", "step": "c_footprint_calibration", "cells": cells})
    over = {p: c for p, c in cells.items() if c["measured_bytes"] > c["predicted_bytes"]}
    if over:
        raise AssertionError(f"3h (c): measured bytes exceed the model: {over}")
    return cells


# ------------------------------------------------------------ recsys family


def recsys_batch(arch: str, cfg, B: int, seed: int, for_loss: bool) -> dict:
    """A seeded numpy batch of the reference's keys for ``arch``: a
    ``criteo_like_batch`` (DIN's context fields as its sparse ids, with
    history and target), or SASRec's item sequences with next items (and
    one sampled negative a position)."""
    from repro_torch.data.synthetic import criteo_like_batch

    if arch in ("autoint", "xdeepfm"):
        data = criteo_like_batch(B, n_sparse=cfg.n_sparse, vocab_sizes=list(cfg.vocab_sizes),
                                 seed=seed)
        b = {"sparse_ids": data["sparse_ids"], "label": data["label"]}
    elif arch == "din":
        data = criteo_like_batch(B, n_sparse=cfg.n_context,
                                 vocab_sizes=[cfg.context_vocab] * cfg.n_context,
                                 hist_len=cfg.seq_len, n_items=cfg.n_items, seed=seed)
        b = {"history": data["history"], "hist_len": data["hist_len"],
             "target_item": data["target_item"], "context_ids": data["sparse_ids"],
             "label": data["label"]}
    else:
        rng = np.random.default_rng(seed)
        seq = rng.integers(0, cfg.n_items, (B, cfg.seq_len + 1)).astype(np.int32)
        b = {"item_seq": seq[:, :-1], "next_items": seq[:, 1:],
             "neg_items": rng.integers(0, cfg.n_items, (B, cfg.seq_len)).astype(np.int32)}
    if not for_loss:
        b = {k: v for k, v in b.items() if k not in ("label", "next_items", "neg_items")}
    return b


def to_card(batch: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).cuda() for k, v in batch.items()}


def event_ms(fn, n: int) -> np.ndarray:
    """Milliseconds of each of ``n`` calls of ``fn`` (CUDA events, each call
    waited for)."""
    out = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return np.asarray(out)


def clone_tree(tree):
    """A copy of a tree of tensors (params, or AdamW state), leaf for leaf."""
    from repro_torch.common.tree import leaves, unflatten

    return unflatten(tree, [t.detach().clone() for t in leaves(tree)])


def phase_recsys(n_cand: int = 1_000_000, serve_batch: int = 512, train_batch: int = 8192,
                 cpu_rows: int = 64, requests: int = 200) -> dict:
    """3g: the recsys family at full published width, and its retrieval_cand
    cell through K1 (see the module docstring)."""
    import dataclasses
    import runpy

    from repro_torch.common.tree import flatten, leaves, unflatten
    from repro_torch.configs import EMBED_DIM_RETRIEVAL, RECSYS_ARCH_IDS, RECSYS_CELLS, get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.models import recsys as rs
    from repro_torch.serve.recsys import padded_candidates, retrieval_step, user_vector
    from repro_torch.train.optimizer import AdamWConfig, init_state
    from repro_torch.train.train_step import make_train_step, recsys_loss_fn

    gc.collect()
    torch.cuda.empty_cache()
    n_pad = padded_candidates(n_cand)
    gen = torch.Generator(device="cuda").manual_seed(21)
    launches, archs, k1_shape, by_shape = 0, {}, None, {}
    for a_i, arch in enumerate(RECSYS_ARCH_IDS):
        t_arch = time.perf_counter()
        cfg = get_config(arch)
        cfg16 = dataclasses.replace(cfg, param_dtype="bfloat16", compute_dtype="bfloat16")
        params = rs.init(cfg, seed=a_i, device="cuda")
        n_params = sum(t.numel() for _, t in flatten(params))
        serve = to_card(recsys_batch(arch, cfg, serve_batch, seed=1, for_loss=False))

        # (b) float32 on the card against the same tables copied to the CPU
        head = {k: v[:cpu_rows] for k, v in serve.items()}
        with torch.no_grad():
            got = rs.forward(params, cfg, head).cpu()
            cpu_params = unflatten(params, [t.cpu() for _, t in flatten(params)])
            want = rs.forward(cpu_params, cfg, {k: v.cpu() for k, v in head.items()})
        del cpu_params
        card_cpu = float((got - want).abs().max()) / float(want.abs().max())
        if not (torch.isfinite(got).all() and card_cpu <= 1e-4):
            raise AssertionError(f"3g {arch}: card vs CPU rel. err {card_cpu}")

        # (a) serve_p99: the cell's bf16 params, B = serve_batch
        p16 = unflatten(params, [t.to(torch.bfloat16) for _, t in flatten(params)])
        del params
        with torch.no_grad():
            for _ in range(5):
                out = rs.forward(p16, cfg16, serve)
            fwd_ms = event_ms(lambda: rs.forward(p16, cfg16, serve), 50)
        want_shape = (serve_batch, cfg.embed_dim) if arch == "sasrec" else (serve_batch,)
        if tuple(out.shape) != want_shape or not torch.isfinite(out).all():
            raise AssertionError(f"3g {arch}: serve output {tuple(out.shape)}, finite "
                                 f"{bool(torch.isfinite(out).all())}")

        # (d) retrieval_cand over n_cand seeded candidates padded to n_pad rows
        d_emb = EMBED_DIM_RETRIEVAL[arch]
        ud = cfg.embed_dim if arch == "sasrec" else 1
        cand = torch.randn(n_pad, d_emb, generator=gen, device="cuda").to(torch.bfloat16)
        cand32 = cand.float()
        proj = (torch.randn(ud, d_emb, generator=gen, device="cuda") / ud ** 0.5).to(torch.bfloat16)
        user = {k: v[:1] for k, v in serve.items()}
        ops.reset_launches()
        scores, ids = retrieval_step(p16, cfg16, user, cand32, proj, n_cand)
        torch.cuda.synchronize()
        step_launches = ops.KERNEL_LAUNCHES["distance_topk"]
        if step_launches != 1:
            raise AssertionError(f"3g {arch}: {step_launches} K1 launches in a retrieval step")
        launches += step_launches
        by_shape = add_shapes(by_shape, shape_launches())
        u = user_vector(p16, cfg16, user, proj)
        d_p, i_p = ref.distance_topk_blocked(u, cand32, 100, "ip", n_valid=n_cand)
        err, swaps = compare_topk(-scores, ids, d_p, i_p, f"3g {arch} retrieval_cand")
        if not (ids.dtype == torch.int32 and bool((ids < n_cand).all())
                and bool((scores[:, 1:] <= scores[:, :-1]).all())):
            raise AssertionError(f"3g {arch}: retrieval output contract")
        rec = {"params": n_params, "serve_batch": serve_batch, "serve_dtype": "bfloat16",
               "serve_p50_ms": float(np.percentile(fwd_ms, 50)),
               "serve_p99_ms": float(np.percentile(fwd_ms, 99)), "serve_calls": len(fwd_ms),
               "card_vs_cpu_rows": cpu_rows, "card_vs_cpu_rel_err": card_cpu,
               "retrieval": {"n_cand": n_cand, "n_pad": n_pad, "d_emb": d_emb,
                             "k1_launches": step_launches, "max_abs_err_vs_plain": err,
                             "tie_swaps": swaps, "top1_score": float(scores[0, 0])}}

        # (e) SASRec's cell timed: single-user requests, then K1 alone
        if arch == "sasrec":
            seqs = to_card(recsys_batch(arch, cfg, requests, seed=2, for_loss=False))
            for r in range(3):  # warm-up
                retrieval_step(p16, cfg16, {"item_seq": seqs["item_seq"][r:r + 1]}, cand32,
                               proj, n_cand)
            ops.reset_launches()
            dev_ms, host_ms = [], []
            for r in range(requests):
                one = {"item_seq": seqs["item_seq"][r:r + 1]}
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                start.record()
                _, ids_r = retrieval_step(p16, cfg16, one, cand32, proj, n_cand)
                end.record()
                ids_r.cpu()  # the user's answer on the host
                host_ms.append(1e3 * (time.perf_counter() - t0))
                end.synchronize()
                dev_ms.append(start.elapsed_time(end))
            req_launches = ops.KERNEL_LAUNCHES["distance_topk"]
            if req_launches != requests:
                raise AssertionError(f"3g sasrec: {req_launches} K1 launches in {requests} "
                                     "requests")
            launches += req_launches
            by_shape = add_shapes(by_shape, shape_launches())
            one = {"item_seq": seqs["item_seq"][:1]}
            tower_ms = event_ms(lambda: user_vector(p16, cfg16, one, proj), 50)
            k1_shape = time_kernel(u.contiguous(), cand32, 100,
                                   f"retrieval_cand: sasrec, 1 x {n_pad:,} x {d_emb}, ip",
                                   metric="ip", n_valid=n_cand)
            rec["requests"] = {"n": requests, "k1_launches": req_launches,
                               "p50_ms": float(np.percentile(dev_ms, 50)),
                               "p99_ms": float(np.percentile(dev_ms, 99)),
                               "host_p50_ms": float(np.percentile(host_ms, 50)),
                               "host_p99_ms": float(np.percentile(host_ms, 99)),
                               "tower_p50_ms": float(np.percentile(tower_ms, 50)),
                               "k1_ms": k1_shape["ms"], "k1_bound_ms": k1_shape["bound_ms"],
                               "topk_mm_ms": k1_shape["library_ms"]}
        del cand, cand32, proj

        # (c) training: the cell's bf16 params, one seeded batch repeated
        train = to_card(recsys_batch(arch, cfg, train_batch, seed=3, for_loss=True))
        opt_state = init_state(p16)
        step_fn = make_train_step(recsys_loss_fn(arch, cfg16),
                                  AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=30))
        losses = []

        def step():
            nonlocal p16, opt_state
            p16, opt_state, m = step_fn(p16, opt_state, train)
            losses.append(float(m["loss"]))  # waits for the step

        step()  # warm-up: step 1
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_ms = event_ms(step, 3)
        peak = torch.cuda.max_memory_allocated()
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
            raise AssertionError(f"3g {arch}: training losses {losses}")
        # run-to-run bits: one step twice from one saved state
        saved = clone_tree(p16), clone_tree(opt_state)
        runs = []
        for _ in range(2):
            p, s, _ = step_fn(clone_tree(saved[0]), clone_tree(saved[1]), train)
            runs.append(leaves(p) + leaves(s["m"]) + leaves(s["v"]))
        differ = sum(not torch.equal(a, b) for a, b in zip(*runs))
        del saved, runs, p, s
        if differ:
            raise AssertionError(f"3g {arch}: {differ} tensors differ between two steps from "
                                 "one state")
        rec["train"] = {"batch": train_batch, "dtype": "bfloat16 params, float32 moments",
                        "losses": losses, "step_ms": step_ms.tolist(),
                        "step_p50_ms": float(np.percentile(step_ms, 50)),
                        "peak_device_bytes": peak, "repeat_step_bit_equal": True}
        rec["seconds"] = time.perf_counter() - t_arch
        emit({"phase": "recsys", "arch": arch, **rec})
        archs[arch] = rec
        del p16, opt_state, train, serve, step_fn
        gc.collect()
        torch.cuda.empty_cache()

    # (f) the example twin, on the card
    ops.reset_launches()
    example = runpy.run_path(str(ROOT / "examples" / "recsys_retrieval_torch.py"),
                             run_name="example")
    r50 = example["main"]("cuda")
    ex_launches = ops.KERNEL_LAUNCHES["distance_topk"]
    if ex_launches <= 0 or not 0.5 <= r50 <= 1.0:
        raise AssertionError(f"3g example: R@50 {r50}, K1 launches {ex_launches}")
    launches += ex_launches
    by_shape = add_shapes(by_shape, shape_launches())
    emit({"phase": "recsys_summary", "n_cand": n_cand,
          "reduced": {"train_batch": f"{RECSYS_CELLS['train_batch']['global_batch']} -> "
                                     f"{train_batch}"},
          "example_r_at_50": r50, "example_k1_launches": ex_launches, "k1_launches": launches})
    return {"launches": launches, "by_shape": by_shape, "timing": k1_shape, "archs": archs}


def k3_case(q, k, v, causal: bool, label: str, v_scale: float = 1.0) -> dict:
    """K3 against its plain version on the same tensors: the max abs error,
    ``bf16_agreement`` with the plain version in float32 (0 for float32)
    and the largest |output|.  Raises past the limits."""
    from repro_torch.kernels import ops, ref

    out = ops.flash_attention(q, k, v, causal=causal)
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    if out.dtype != q.dtype or out.shape != v.shape:
        raise AssertionError(f"K3 {label}: output {out.dtype} {tuple(out.shape)}")
    err = float((out.float() - want.float()).abs().max())
    agree = 0.0
    if q.dtype == torch.bfloat16:
        want32 = ref.flash_attention_ref(q.float(), k.float(), v.float(), causal=causal)
        agree = ref.bf16_agreement(out, want32)
    if not (err <= K3_TOL[q.dtype] * v_scale and agree <= 1.0):
        raise AssertionError(f"K3 {label}: max abs err {err}, bf16 agreement {agree}")
    return {"max_abs_err": err, "bf16_agreement": agree,
            "max_abs_out": float(out.float().abs().max())}


def k3_misaligned_case(gen, BH: int = 7, S: int = 1000, D: int = 64) -> dict:
    """float32 q, k, v that start 4 bytes off the 16-byte grid: the launcher
    refuses them (the kernel copies rows in 16-byte pieces), and
    ``ops.flash_attention`` copies them first and holds the limit."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    n = BH * S * D
    flat = torch.randn(3 * n + 1, generator=gen, device="cuda")[1:]
    q, k, v = (flat[i * n:(i + 1) * n].view(BH, S, D) for i in range(3))
    if not all(t.is_contiguous() and t.data_ptr() % 16 for t in (q, k, v)):
        raise AssertionError("K3 misaligned case: the views are not off the 16-byte grid")
    try:
        flash_attention_cuda(q, k, v, causal=True, scale=D ** -0.5)
    except ValueError:
        pass
    else:
        raise AssertionError("K3 launcher took float32 inputs off the 16-byte grid")
    res = k3_case(q, k, v, True, f"float32 off the 16-byte grid, BH={BH} S={S} D={D}")
    return {"cases": 1, **res}


def phase_flash_vs_plain() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    dtypes, dims, v_big = (torch.float32, torch.bfloat16), (16, 32, 64, 128), 8.0
    f32 = torch.float32
    # (dtype, D, Dv, S, causal, BH, v scale, q scale)
    groups = {
        "shapes": [(dtype, D, D, S, causal, BH, 1.0, 1.0) for dtype in dtypes for D in dims
                   for S in (1, 100, 128, 200, 1025, 4096) for causal in (True, False)
                   for BH in (1, 15, 30)],
        # float32 also at its kv tiles (64 rows up to D = 64, 32 at 128, 16 at
        # MLA's (192, 128)) and q blocks (128 rows up to D = 64, 64 past it)
        "tile_edges": [(dtype, D, D, S, causal, BH, 1.0, 1.0) for dtype in dtypes for D in dims
                       for S in (15, 17, 63, 65, 1000, 4097)
                       + ((31, 33, 127, 129) if dtype == f32 else ())
                       for causal in (True, False) for BH in (1, 7)]
                      + [(f32, 192, 128, S, causal, BH, 1.0, 1.0)
                         for S in (15, 17, 31, 33, 63, 127, 129) for causal in (True, False)
                         for BH in (1, 7)],
        # MLA's instance: q . k over 192 dims (128 nope + 64 rope), v 128
        "mla_head_dims": [(dtype, 192, 128, S, causal, BH, 1.0, 1.0) for dtype in dtypes
                          for S in (1, 65, 1000, 4097) for causal in (True, False)
                          for BH in (1, 16)],
        # |o| past 4, where a bf16 ulp is 3.1e-2; the limit scales with v
        "v_scaled": [(torch.bfloat16, 64, 64, 1000, True, 7, v_big, 1.0)]
                    + [(f32, D, D, 1000, causal, 7, v_big, 1.0) for D in dims
                       for causal in (True, False)],
        # a peaky softmax: scores 4x larger, p near one-hot
        "q_peaky": [(f32, D, D, S, causal, 7, 1.0, 4.0) for D in dims for S in (1000, 4097)
                    for causal in (True, False)],
    }
    summary = {}
    for name, cases in groups.items():
        g = summary[name] = {"cases": len(cases), "max_abs_err_f32": 0.0, "max_abs_err_bf16": 0.0,
                             "max_bf16_agreement": 0.0, "max_abs_out": 0.0}
        for dtype, D, Dv, S, causal, BH, v_scale, q_scale in cases:
            q, k = (torch.randn(BH, S, D, generator=gen, device="cuda") for _ in range(2))
            v = torch.randn(BH, S, Dv, generator=gen, device="cuda")
            q, k, v = (q * q_scale).to(dtype), k.to(dtype), (v * v_scale).to(dtype)
            res = k3_case(q, k, v, causal, f"{dtype} D={D} Dv={Dv} S={S} causal={causal} "
                                           f"BH={BH} v x{v_scale:g} q x{q_scale:g}", v_scale)
            key = "max_abs_err_f32" if dtype == f32 else "max_abs_err_bf16"
            g[key] = max(g[key], res["max_abs_err"])
            g["max_bf16_agreement"] = max(g["max_bf16_agreement"], res["bf16_agreement"])
            g["max_abs_out"] = max(g["max_abs_out"], res["max_abs_out"])
    summary["misaligned_f32"] = k3_misaligned_case(gen)
    unit = [summary["shapes"], summary["tile_edges"], summary["mla_head_dims"],
            summary["q_peaky"]]  # v at unit scale
    out = {"f32": max(max(g["max_abs_err_f32"] for g in unit),
                      summary["misaligned_f32"]["max_abs_err"]),
           "bf16": max(g["max_abs_err_bf16"] for g in unit),
           "bf16_agreement": max(summary[name]["max_bf16_agreement"] for name in groups)}
    emit({"phase": "flash_vs_plain", "cases": sum(len(c) for c in groups.values()) + 1,
          "max_abs_err_f32": out["f32"], "tol_f32": K3_TOL[f32],
          "max_abs_err_bf16": out["bf16"], "tol_bf16": K3_TOL[torch.bfloat16],
          "max_bf16_agreement": out["bf16_agreement"], "bf16_agreement_limit": 1.0,
          "v_scaled_tol_f32": K3_TOL[f32] * v_big,
          "v_scaled_tol_bf16": K3_TOL[torch.bfloat16] * v_big, "groups": summary})
    # no driven path runs head dim 128 (smollm-360m's is 64): time the bf16
    # D = 128 instance here, at codeqwen1.5-7b's 32 heads and an 8k prompt
    q, k, v = (torch.randn(32, 8192, 128, generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    time_flash_kernel(q, k, v, "codeqwen1.5-7b heads, seeded: BH=32, S=8192, D=128")
    # MLA's instance at deepseek-v2-lite-16b's 16 heads and a 32k prompt
    q, k = (torch.randn(16, 32768, 192, generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    v = torch.randn(16, 32768, 128, generator=gen, device="cuda").to(torch.bfloat16)
    time_flash_kernel(q, k, v, "deepseek-v2-lite-16b heads, seeded: BH=16, S=32768, D=192, "
                               "Dv=128")
    return out


class RecordAttention:
    """Keeps the inputs and output of chosen calls of
    ``ops.flash_attention_bhsd`` (by call index) while the model runs, and
    counts the calls on the card by (dtype, BH, S, D, Dv); the calls
    themselves go through unchanged."""

    def __init__(self, keep=()):
        self.keep, self.calls, self.seen = set(keep), {}, 0
        self.shapes: dict[tuple, int] = {}

    def __enter__(self):
        from repro_torch.kernels import ops

        self._orig = ops.flash_attention_bhsd

        def recording(q, k, v, **kw):
            out = self._orig(q, k, v, **kw)
            if q.is_cuda:
                B, S, H, D = q.shape
                key = (q.dtype, B * H, S, D, v.shape[-1])
                self.shapes[key] = self.shapes.get(key, 0) + 1
            if self.seen in self.keep:
                self.calls[self.seen] = tuple(t.clone() for t in (q, k, v, out))
            self.seen += 1
            return out

        ops.flash_attention_bhsd = recording
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops

        ops.flash_attention_bhsd = self._orig
        return False


def fold_bhsd(x: torch.Tensor) -> torch.Tensor:
    B, S, H, D = x.shape
    return x.permute(0, 2, 1, 3).reshape(B * H, S, D).contiguous()


def sdpa_backend(q, k, v, scale: float) -> str:
    """The backend PyTorch's SDPA picks for these (BH, S, D) inputs, causal:
    the first of its priority order that takes their first 128 rows alone
    (its checks read dtypes, head dims and strides, not the length)."""
    import warnings

    from torch.nn.attention import SDPBackend, sdpa_kernel

    for b in torch._C._get_sdp_priority_order():
        backend = SDPBackend(b)
        try:
            with sdpa_kernel([backend]), warnings.catch_warnings():
                warnings.simplefilter("ignore")  # each refusal warns why
                torch.nn.functional.scaled_dot_product_attention(
                    q[None, :, :128], k[None, :, :128], v[None, :, :128], is_causal=True,
                    scale=scale)
            return backend.name
        except RuntimeError:
            continue
    return "none"


def time_flash_kernel(q, k, v, label: str) -> dict:
    """K3 at one main-path shape, q, k (BH, S, D) and v (BH, S, Dv),
    causal: K3 / plain / SDPA milliseconds (and the backend SDPA picked)
    and K3's bound for the inputs' dtype."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    BH, S, D = q.shape
    Dv = v.shape[-1]
    scale = 1.0 / D ** 0.5
    kern = lambda: flash_attention_cuda(q, k, v, causal=True, scale=scale)
    plain = lambda: ref.flash_attention_ref(q, k, v, causal=True, scale=scale)
    # yardstick only: PyTorch's fused attention on the same tensors
    library = lambda: torch.nn.functional.scaled_dot_product_attention(
        q[None], k[None], v[None], is_causal=True, scale=scale)
    err = float((kern().float() - plain().float()).abs().max())
    ms = cuda_ms(kern, iters=5, warmup=1)
    plain_ms = cuda_ms(plain, iters=2, warmup=1)
    library_ms = cuda_ms(library, iters=10, warmup=2)
    flops = 1.0 * BH * S * S * (D + Dv)  # q k^T and p v over the causal half
    nbytes = 2.0 * BH * S * (D + Dv) * q.element_size()  # q, k, v read, o written
    t_ops, t_bytes = flops / K3_PEAK[q.dtype], nbytes / PEAK_HBM_BYTES
    rec = {"shape": label, "BH": BH, "S": S, "D": D, "Dv": Dv, "dtype": str(q.dtype),
           "causal": True, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "library_backend": sdpa_backend(q, k, v, scale),
           "bound_ms": 1e3 * max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "achieved_tflops": flops / (ms * 1e-3) / 1e12}
    emit({"phase": "flash_timing", **rec})
    if err > K3_TOL[q.dtype]:
        raise AssertionError(f"K3 at {label}: max abs err {err}")
    return rec


def phase_prefill_32k(S: int = 32_768, B: int = 1) -> dict:
    from repro_torch.configs import get_config, serving_config
    from repro_torch.kernels import ops, ref
    from repro_torch.models import transformer as tf
    from repro_torch.serve import make_prefill_fn

    gc.collect()
    torch.cuda.empty_cache()
    cfg = serving_config(get_config("smollm-360m"), "prefill")
    L = cfg.n_layers
    t0 = time.perf_counter()
    params = tf.init(cfg, seed=0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen, device="cuda")
    cache = tf.make_cache(cfg, B, S, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prefill = make_prefill_fn(cfg)
    prefill(params, tokens[:, :2048], cache)  # warm-up: cuBLAS plans, K3's first launch

    torch.cuda.reset_peak_memory_stats()
    with RecordAttention(keep=(0, L - 1)) as rec:
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(params, tokens, cache)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = ops.KERNEL_LAUNCHES["flash_attention"]
    peak = torch.cuda.max_memory_allocated()
    if launches != L:
        raise AssertionError(f"prefill_32k: K3 launched {launches} times for {L} layers")
    if logits.shape != (B, cfg.vocab) or not torch.isfinite(logits).all():
        raise AssertionError(f"prefill_32k: logits {tuple(logits.shape)} not finite")
    if not (cache["k"][:, :, S - 1].abs().sum(-1) > 0).all():
        raise AssertionError("prefill_32k: the cache's last position was not written")
    layer_err, layer_agree = {}, {}
    for i, (q, k, v, out) in sorted(rec.calls.items()):
        q, k, v, out = (fold_bhsd(t) for t in (q, k, v, out))
        want = ref.flash_attention_ref(q, k, v, causal=True)
        layer_err[f"layer_{i}"] = float((out.float() - want.float()).abs().max())
        want32 = ref.flash_attention_ref(q.float(), k.float(), v.float(), causal=True)
        layer_agree[f"layer_{i}"] = ref.bf16_agreement(out, want32)
    if max(layer_err.values()) > K3_TOL[torch.bfloat16] or max(layer_agree.values()) > 1.0:
        raise AssertionError(f"prefill_32k: K3 vs plain {layer_err}, bf16 agreement "
                             f"{layer_agree}")
    q, k, v, _ = rec.calls[0]
    shapes = rec.shapes
    del logits, cache, params, rec
    timing = time_flash_kernel(fold_bhsd(q), fold_bhsd(k), fold_bhsd(v),
                               f"prefill_32k layer 0: smollm-360m, S={S}")
    emit({"phase": "prefill_32k", "arch": "smollm-360m", "n_layers": L, "d_model": cfg.d_model,
          "dtype": "bfloat16", "q_chunk": cfg.q_chunk, "S": S, "B": B,
          "reduced": {"global_batch": f"32 -> {B}"},
          "init_s": init_s, "seconds": seconds, "prefill_tokens_per_s": B * S / seconds,
          "k3_launches": launches, "k3_vs_plain_max_abs_err": layer_err,
          "k3_vs_plain_bf16_agreement": layer_agree, "peak_device_bytes": peak})
    if shapes != {(torch.bfloat16, q.shape[0] * q.shape[2], S, q.shape[3],
                   v.shape[3]): launches}:
        raise AssertionError(f"prefill_32k: K3 launches by shape {shapes}")
    return {"launches": launches, "max_abs_err": max(layer_err.values()),
            "instances": [{**timing, "launches": launches}]}


def phase_serve_engine(n_requests: int = 8, max_new: int = 32, cpu_layers: int = 4) -> dict:
    import copy
    import dataclasses

    from repro_torch.configs import get_config, serving_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tf
    from repro_torch.serve import Request, ServeEngine

    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(serving_config(get_config("smollm-360m"), "prefill"),
                              param_dtype="float32", compute_dtype="float32")
    params = tf.init(cfg, seed=0)
    eng = ServeEngine(cfg, params, slots=4, max_seq=4096)
    rng = np.random.default_rng(0)
    reqs = [Request(u, rng.integers(0, cfg.vocab, int(n)).astype(np.int32), max_new_tokens=max_new)
            for u, n in enumerate(rng.integers(1100, 4001, n_requests))]
    prefill_s, decode_s = [], []

    def timed(fn, out):
        def call(*a):
            t0 = time.perf_counter()
            res = fn(*a)
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
            return res
        return call

    eng._prefill = timed(eng._prefill, prefill_s)
    eng._decode = timed(eng._decode, decode_s)
    for r in reqs:
        eng.submit(r)
    with RecordAttention() as rec:
        ops.reset_launches()
        t0 = time.perf_counter()
        stats = dict(eng.run())
        wall = time.perf_counter() - t0
        launches = ops.KERNEL_LAUNCHES["flash_attention"]
    if sum(rec.shapes.values()) != launches:
        raise AssertionError(f"serve_engine: K3 launches by shape {rec.shapes}, total {launches}")
    buckets = [eng._prompt_bucket(len(r.prompt)) for r in reqs]
    want_launches = cfg.n_layers * sum(b > cfg.q_chunk for b in buckets)
    if stats["completed"] != n_requests or launches != want_launches or launches <= 0:
        raise AssertionError(f"serve_engine: stats {stats}, K3 launches {launches} "
                             f"(want {want_launches})")
    for r in reqs:
        if len(r.tokens_out) != max_new or not all(0 <= t < cfg.vocab for t in r.tokens_out):
            raise AssertionError(f"serve_engine: request {r.uid} tokens {r.tokens_out}")
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()

    # the same engine on the card and on the CPU (plain path), cut to
    # cpu_layers layers at full width: equal first token, close last logits
    cfg_c = dataclasses.replace(cfg, n_layers=cpu_layers)
    cpu_params = tf.init(cfg_c, seed=0, device="cpu")
    gpu_params = copy.deepcopy(cpu_params).to("cuda")
    prompt = rng.integers(0, cfg.vocab, 1100).astype(np.int32)
    first, last_logits = {}, {}
    for name, p in (("cuda", gpu_params), ("cpu", cpu_params)):
        e = ServeEngine(cfg_c, p, slots=1, max_seq=4096)
        inner = e._prefill

        def keep_logits(*a, name=name, inner=inner):
            lg, c = inner(*a)
            last_logits[name] = lg[0].float().cpu()
            return lg, c

        e._prefill = keep_logits
        r = Request(0, prompt, max_new_tokens=1)
        e.submit(r)
        ops.reset_launches()
        e.run()
        first[name] = r.tokens_out[0]
        if name == "cuda" and ops.KERNEL_LAUNCHES["flash_attention"] != cpu_layers:
            raise AssertionError("serve_engine: the card check did not launch K3")
    gap = float((last_logits["cuda"] - last_logits["cpu"]).abs().max())
    dec = np.asarray(decode_s)
    emit({"phase": "serve_engine", "arch": "smollm-360m", "n_layers": cfg.n_layers,
          "dtype": "float32", "slots": 4, "max_seq": 4096, "q_chunk": cfg.q_chunk,
          "requests": n_requests, "prompt_lengths": [len(r.prompt) for r in reqs],
          "buckets": buckets, "max_new_tokens": max_new, "stats": stats, "wall_s": wall,
          "prefill_s": float(sum(prefill_s)),
          "prefill_tokens_per_s": stats["prefill_tokens"] / sum(prefill_s),
          "prefill_bucket_tokens_per_s": sum(buckets) / sum(prefill_s),
          "decode_steps_per_s": len(dec) / dec.sum(),
          "decode_step_p50_ms": 1e3 * float(np.percentile(dec, 50)),
          "decode_step_p99_ms": 1e3 * float(np.percentile(dec, 99)),
          "k3_launches": launches,
          "k3_launches_by_shape": {f"{BH}x{S}x{D}": n for (_, BH, S, D, _), n in rec.shapes.items()},
          "cpu_check": {"reduced": {"n_layers": f"32 -> {cpu_layers}"}, "prompt": len(prompt),
                        "first_token": first, "last_logits_max_abs_gap": gap, "tol": 1e-3}})
    if first["cuda"] != first["cpu"] or gap > 1e-3:
        raise AssertionError(f"serve_engine: card vs CPU first token {first}, gap {gap}")
    # K3 in float32 at each shape the prefills ran, seeded (the kernel's
    # time does not depend on the values)
    gen = torch.Generator(device="cuda").manual_seed(2)
    instances = []
    for (dtype, BH, S, D, _), n in sorted(rec.shapes.items(), key=lambda kv: -kv[0][2]):
        q, k, v = (torch.randn(BH, S, D, generator=gen, device="cuda", dtype=dtype)
                   for _ in range(3))
        timing = time_flash_kernel(q, k, v, f"serve_engine bucket: smollm-360m, S={S}")
        instances.append({**timing, "launches": n})
    return {"launches": launches, "instances": instances}


# ------------------------------------------------------------------ K3-bwd


def k3_bwd_case(q, k, v, do, causal: bool, label: str) -> dict:
    """K3 with its row log-sum-exp and K3-bwd against the plain versions on
    the same tensors (run in float32): lse within 1e-4, the output with lse
    bit-equal to the output without it, and per tensor (dq, dk, dv)
    max |kernel - plain| / max |plain| <= 1e-4 (float32) or
    ``ref.bf16_agreement`` <= 1 (bfloat16).  Raises past the limits."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    scale = q.shape[-1] ** -0.5
    fwd_in = [ops._aligned(t) for t in (q, k, v)]  # K3's launcher takes the grid only
    out, lse = flash_attention_cuda(*fwd_in, causal=causal, scale=scale, with_lse=True)
    bare = flash_attention_cuda(*fwd_in, causal=causal, scale=scale)
    got = ops.flash_attention_bwd(q, k, v, out, do, lse, causal=causal, scale=scale)
    f = lambda t: t.float()
    _, lse_plain = ref.flash_attention_ref(f(q), f(k), f(v), causal=causal, scale=scale,
                                           with_lse=True)
    want = ref.flash_attention_bwd_ref(f(q), f(k), f(v), f(out), f(do), lse, causal=causal,
                                       scale=scale)
    torch.cuda.synchronize()
    res = {"lse_max_abs_err": float((lse - lse_plain).abs().max()),
           "out_bit_equal": bool(torch.equal(out, bare)), "max_abs_err": 0.0, "rel_err": 0.0,
           "bf16_agreement": 0.0}
    for name, a, w, like in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
        if a.dtype != q.dtype or a.shape != like.shape:
            raise AssertionError(f"K3-bwd {label}: {name} {a.dtype} {tuple(a.shape)}")
        err = float((a.float() - w).abs().max())
        res["max_abs_err"] = max(res["max_abs_err"], err)
        if q.dtype == torch.float32:
            res["rel_err"] = max(res["rel_err"], err / max(float(w.abs().max()), 1e-30))
        else:
            res["bf16_agreement"] = max(res["bf16_agreement"], ref.bf16_agreement(a, w))
    if not (res["lse_max_abs_err"] <= 1e-4 and res["out_bit_equal"]
            and res["rel_err"] <= K3_BWD_REL_TOL and res["bf16_agreement"] <= 1.0):
        raise AssertionError(f"K3-bwd {label}: {res}")
    return res


def k3_bwd_layout_cases(gen) -> dict:
    """A dO that is a permuted view (autograd's layout through the (B, S, H,
    D) fold) and a float32 q 4 bytes off the 16-byte grid, which the
    launcher refuses and ``ops.flash_attention_bwd`` copies."""
    from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd_cuda

    BH, S, D = 7, 1000, 64
    q, k, v = (torch.randn(BH, S, D, generator=gen, device="cuda") for _ in range(3))
    do = torch.randn(S, BH, D, generator=gen, device="cuda").transpose(0, 1)
    if do.is_contiguous():
        raise AssertionError("K3-bwd layout case: dO is contiguous")
    strided = k3_bwd_case(q, k, v, do, True, "float32 with a permuted dO")
    flat = torch.empty(BH * S * D + 1, device="cuda")[1:]
    q_off = flat.view(BH, S, D)
    q_off.copy_(q)
    if q_off.data_ptr() % 16 == 0:
        raise AssertionError("K3-bwd layout case: q is on the 16-byte grid")
    try:
        flash_attention_bwd_cuda(q_off, k, v, q, do.contiguous(),
                                 torch.zeros(BH, S, device="cuda"), causal=True, scale=0.125)
    except ValueError:
        pass
    else:
        raise AssertionError("K3-bwd launcher took float32 inputs off the 16-byte grid")
    misaligned = k3_bwd_case(q_off, k, v, do.contiguous(), True, "float32 q off the grid")
    return {"cases": 2, **{key: max(strided[key], misaligned[key])
                           for key in ("max_abs_err", "rel_err", "lse_max_abs_err")}}


def time_flash_bwd_kernel(q, k, v, do, label: str) -> dict:
    """K3-bwd at one shape, q, k (BH, S, D) and v, dO (BH, S, Dv), causal:
    K3-bwd / plain / SDPA-backward milliseconds and the bound, after a
    check against the plain version in float32 (bf16 agreement <= 1;
    float32 relative error <= K3_BWD_REL_TOL).  SDPA's backward is timed as
    (forward + backward) - forward on the backend SDPA picks (recorded),
    and is a yardstick only."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd_cuda

    BH, S, D = q.shape
    Dv = v.shape[-1]
    scale = 1.0 / D ** 0.5
    out, lse = flash_attention_cuda(q, k, v, causal=True, scale=scale, with_lse=True)
    kern = lambda: flash_attention_bwd_cuda(q, k, v, out, do, lse, causal=True, scale=scale)
    plain = lambda: ref.flash_attention_bwd_ref(q, k, v, out, do, lse, causal=True, scale=scale)
    f = lambda t: t.float()
    want = ref.flash_attention_bwd_ref(f(q), f(k), f(v), f(out), f(do), lse, causal=True,
                                       scale=scale)
    got = kern()
    err = max(float((a.float() - w).abs().max()) for a, w in zip(got, want))
    rel = max(float((a.float() - w).abs().max()) / max(float(w.abs().max()), 1e-30)
              for a, w in zip(got, want))
    agree = max(ref.bf16_agreement(a, w) for a, w in zip(got, want)) if q.dtype == torch.bfloat16 \
        else 0.0
    del want, got
    ms = cuda_ms(kern, iters=5, warmup=1)
    plain_ms = cuda_ms(plain, iters=2, warmup=1)
    qs, ks, vs = (t[None].detach().clone().requires_grad_() for t in (q, k, v))
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                                                    scale=scale)
    sdpa_fwd_ms = cuda_ms(lambda: sdpa().detach(), iters=10, warmup=2)
    sdpa_both_ms = cuda_ms(lambda: torch.autograd.grad(sdpa(), (qs, ks, vs), do[None]),
                           iters=10, warmup=2)
    del qs, ks, vs
    # the gradient: 2.5x the forward's BH S^2 (D + Dv) over the causal half
    flops = 2.5 * BH * S * S * (D + Dv)
    # q, k, v, o, dO in, dq, dk, dv out, and lse
    nbytes = 4.0 * BH * S * (D + Dv) * q.element_size() + 4.0 * BH * S
    t_ops, t_bytes = flops / K3_PEAK[q.dtype], nbytes / PEAK_HBM_BYTES
    rec = {"shape": label, "BH": BH, "S": S, "D": D, "Dv": Dv, "dtype": str(q.dtype),
           "causal": True, "max_abs_err": err, "rel_err": rel, "bf16_agreement": agree, "ms": ms,
           "plain_ms": plain_ms,
           "library_ms": sdpa_both_ms - sdpa_fwd_ms,
           "library_backend": sdpa_backend(q, k, v, scale), "library_fwd_bwd_ms": sdpa_both_ms,
           "library_fwd_ms": sdpa_fwd_ms, "bound_ms": 1e3 * max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "achieved_tflops": flops / (ms * 1e-3) / 1e12}
    emit({"phase": "flash_bwd_timing", **rec})
    if agree > 1.0 or (q.dtype == torch.float32 and rel > K3_BWD_REL_TOL):
        raise AssertionError(f"K3-bwd at {label}: bf16 agreement {agree}, rel. err {rel}")
    return rec


def phase_flash_bwd_vs_plain() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(3)
    # (dtype, (D, Dv), S, causal, q scale, v scale): every K3 instance, MLA's
    # (192, 128) included; float32 also on a peaky softmax (q x 4) and large
    # values (v x 8), as phase 2c gives K3
    dims = [(d, d) for d in (16, 32, 64, 128)] + [(192, 128)]
    cases = [(dtype, dd, S, causal, 1.0, 1.0) for dtype in (torch.float32, torch.bfloat16)
             for dd in dims for S in (64, 1000, 4096) for causal in (True, False)]
    cases += [(torch.float32, dd, S, causal, qs, vs) for dd in dims
              for S in (64, 1000) for causal in (True, False) for qs, vs in ((4.0, 1.0), (1.0, 8.0))]
    worst = {"max_abs_err": 0.0, "rel_err": 0.0, "bf16_agreement": 0.0, "lse_max_abs_err": 0.0}
    for dtype, (D, Dv), S, causal, qs, vs in cases:
        BH = 2 if S == 4096 else 3
        q, k = (torch.randn(BH, S, D, generator=gen, device="cuda") for _ in range(2))
        v, do = (torch.randn(BH, S, Dv, generator=gen, device="cuda") for _ in range(2))
        q, k, v, do = (q * qs).to(dtype), k.to(dtype), (v * vs).to(dtype), do.to(dtype)
        res = k3_bwd_case(q, k, v, do, causal, f"{dtype} D={D} Dv={Dv} S={S} causal={causal} "
                                               f"BH={BH} q x{qs:g} v x{vs:g}")
        for key in worst:
            worst[key] = max(worst[key], res[key])
    layout = k3_bwd_layout_cases(gen)
    emit({"phase": "flash_bwd_vs_plain", "cases": len(cases) + layout["cases"],
          "max_abs_err": max(worst["max_abs_err"], layout["max_abs_err"]),
          "max_rel_err_f32": max(worst["rel_err"], layout["rel_err"]),
          "rel_tol_f32": K3_BWD_REL_TOL, "max_bf16_agreement": worst["bf16_agreement"],
          "bf16_agreement_limit": 1.0,
          "lse_max_abs_err": max(worst["lse_max_abs_err"], layout["lse_max_abs_err"]),
          "out_with_lse_bit_equal": True})
    # the layer shapes of 6b (smollm-360m's 15 heads x 4 sequences a
    # microbatch) and 6d (the DeepSeek LMs' 16 heads x 4 sequences: GQA at
    # 128, MLA at 192 -> 128), one sequence of codeqwen1.5-7b's 32 heads at
    # train_4k (D = 128), in bf16, and float32 (3xTF32) at D = 64 and 128
    timings = {}
    for key, (BH, S, D, Dv), dtype, label in (
            ("6b", (60, 4096, 64, 64), torch.bfloat16,
             "train_4k layer: smollm-360m, 4 x 4096 tokens"),
            ("6d deepseek-moe-16b", (64, 4096, 128, 128), torch.bfloat16,
             "train_4k layer: deepseek-moe-16b, 4 x 4096 tokens"),
            ("6d deepseek-v2-lite-16b", (64, 4096, 192, 128), torch.bfloat16,
             "train_4k layer: deepseek-v2-lite-16b (MLA), 4 x 4096 tokens"),
            ("codeqwen", (32, 4096, 128, 128), torch.bfloat16,
             "train_4k layer: codeqwen1.5-7b, 1 x 4096 tokens"),
            ("f32 64", (60, 4096, 64, 64), torch.float32, "smollm-360m's layer in float32"),
            ("f32 128", (32, 4096, 128, 128), torch.float32,
             "codeqwen1.5-7b's layer in float32")):
        q, k = (torch.randn(BH, S, D, generator=gen, device="cuda").to(dtype) for _ in range(2))
        v, do = (torch.randn(BH, S, Dv, generator=gen, device="cuda").to(dtype) for _ in range(2))
        timings[key] = time_flash_bwd_kernel(q, k, v, do, label)
        del q, k, v, do
    return {"max_abs_err": max(worst["max_abs_err"], layout["max_abs_err"],
                               *(t["max_abs_err"] for t in timings.values())),
            "timing": timings["6b"], "timings": timings}


# ------------------------------------------------------------ training step


def train_card_vs_cpu(n_layers: int = 2, S: int = 1100, q_chunk: int = 256) -> dict:
    """The grads of one train step of smollm-360m's first ``n_layers``
    layers at full width in float32, 2 sequences in 2 microbatches (K3 f32
    and K3-bwd on the card, the plain versions on the CPU), from the same
    params carried through ``convert``'s numpy: loss within 1e-5 relative,
    every grad tensor within 1e-3 of the CPU's largest entry, the grad norm
    within 1e-4 relative.  (The AdamW update is the same torch ops on
    both.)"""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.convert import transformer_from_jax, transformer_to_numpy
    from repro_torch.data.synthetic import token_batch
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tf
    from repro_torch.train.optimizer import global_norm
    from repro_torch.train.train_step import _accumulate_grads, lm_loss_fn

    cfg = dataclasses.replace(get_config("smollm-360m"), n_layers=n_layers, q_chunk=q_chunk,
                              remat=True)
    params_np = transformer_to_numpy(tf.init(cfg, seed=0, device="cpu"))
    toks, labels = token_batch(2, S, cfg.vocab, seed=5)
    batch = {"tokens": toks, "labels": labels}
    out = {}
    for name in ("cuda", "cpu"):
        params = transformer_from_jax(cfg, params_np, device=name)
        ops.reset_launches()
        loss, grads, _ = _accumulate_grads(lm_loss_fn(cfg), params, batch, 2)
        gnorm = float(global_norm(grads))
        if name == "cuda":
            launches = dict(ops.KERNEL_LAUNCHES)
        out[name] = (float(loss), [g.cpu() for g in grads], gnorm)
    (lg, gg, ng), (lc, gc, nc) = out["cuda"], out["cpu"]
    grad_err = max(float((a - b).abs().max()) / float(b.abs().max()) for a, b in zip(gg, gc))
    rec = {"reduced": {"n_layers": f"32 -> {n_layers}", "dtype": "bfloat16 -> float32",
                       "S": f"4096 -> {S}", "q_chunk": f"1024 -> {q_chunk}"},
           "sequences": 2, "num_micro": 2,
           "loss_cuda": lg, "loss_cpu": lc, "loss_rel_err": abs(lg - lc) / abs(lc),
           "grad_max_rel_err": grad_err, "grad_norm_cuda": ng, "grad_norm_cpu": nc,
           "grad_norm_rel_err": abs(ng - nc) / nc,
           "k3_launches": launches["flash_attention"],
           "k3_bwd_launches": launches["flash_attention_bwd"]}
    if not (rec["loss_rel_err"] <= 1e-5 and grad_err <= 1e-3 and rec["grad_norm_rel_err"] <= 1e-4
            and rec["k3_launches"] == 2 * 2 * n_layers and rec["k3_bwd_launches"] == 2 * n_layers):
        raise AssertionError(f"train card vs CPU: {rec}")
    return rec


def train_entry_point(workdir: str) -> dict:
    """``python -m repro_torch.launch.train`` on the card (the arch's reduced
    config): 4 steps with a checkpoint every 2, then ``--resume`` from it;
    the resumed run's final loss must equal the first run's."""
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--steps", "4", "--ckpt-dir",
           os.path.join(workdir, "entry"), "--ckpt-every", "2", "--log-every", "1"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    runs = {}
    for name, extra in (("first", []), ("resumed", ["--resume"])):
        t0 = time.perf_counter()
        p = subprocess.run(cmd + extra, capture_output=True, text=True, env=env, cwd=ROOT,
                           timeout=300)
        if p.returncode != 0:
            raise AssertionError(f"launch.train {name} exited {p.returncode}:\n{p.stderr[-3000:]}")
        final = [line for line in p.stdout.splitlines() if line.startswith("done: final loss")]
        runs[name] = {"seconds": time.perf_counter() - t0, "final": final[-1] if final else None,
                      "resumed_line": "resumed from step 2" in p.stdout,
                      "device_line": "device=cuda" in p.stdout}
    ok = (runs["first"]["final"] is not None and runs["first"]["final"] == runs["resumed"]["final"]
          and runs["resumed"]["resumed_line"] and runs["first"]["device_line"])
    if not ok:
        raise AssertionError(f"launch.train resume: {runs}")
    return runs


def phase_train_step(S: int = 4096, global_batch: int = 16, num_micro: int = 4,
                     steps: int = 5) -> dict:
    import shutil
    import tempfile

    from repro_torch.common.tree import leaves
    from repro_torch.configs import get_config, training_config
    from repro_torch.data.synthetic import token_batch
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tf
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.optimizer import AdamWConfig, init_state
    from repro_torch.train.train_step import lm_loss_fn, make_train_step

    gc.collect()
    torch.cuda.empty_cache()
    cfg = training_config(get_config("smollm-360m"))
    L = cfg.n_layers
    params = tf.init(cfg, seed=0)
    opt_state = init_state(params)
    step_fn = make_train_step(lm_loss_fn(cfg), AdamWConfig(lr=1e-3, warmup_steps=2,
                                                           total_steps=10), num_micro=num_micro)
    toks, labels = token_batch(global_batch, S, cfg.vocab, seed=0)
    batch = {"tokens": torch.from_numpy(toks).cuda(), "labels": torch.from_numpy(labels).cuda()}
    losses = []

    def step():
        nonlocal params, opt_state
        params, opt_state, m = step_fn(params, opt_state, batch)
        losses.append(float(m["loss"]))  # waits for the step

    step()  # warm-up: step 1, cuBLAS plans and the kernel libraries
    (ROOT / "build").mkdir(exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="train_6b_", dir=ROOT / "build")
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, saved = [], None
        mgr = CheckpointManager(os.path.join(workdir, "ckpt"))
        with RecordAttention() as rec:
            ops.reset_launches()
            for i in range(steps):  # steps 2 .. steps + 1
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                step()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
                if len(losses) == 3:  # checkpoint the state after step 3
                    tree = {"p": tf.param_tree(params), "o": opt_state}
                    saved = [t.detach().cpu() for t in leaves(tree)]  # off the card's peak
                    t0 = time.perf_counter()
                    mgr.save(3, tree, extra={"loss": losses[-1]})
                    save_s = time.perf_counter() - t0
            launches = dict(ops.KERNEL_LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        shapes = rec.shapes
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
            raise AssertionError(f"train step: losses {losses}")
        per_step_fwd, per_step_bwd = launches["flash_attention"] / steps, \
            launches["flash_attention_bwd"] / steps
        want_fwd, want_bwd = 2 * L * num_micro, L * num_micro  # remat: each forward twice
        if per_step_fwd != want_fwd or per_step_bwd != want_bwd:
            raise AssertionError(f"train step: K3 {per_step_fwd} / K3-bwd {per_step_bwd} "
                                 f"launches a step, want {want_fwd} / {want_bwd}")
        B_micro = global_batch // num_micro
        if set(shapes) != {(torch.bfloat16, B_micro * cfg.n_heads, S, cfg.head_dim,
                            cfg.head_dim)}:
            raise AssertionError(f"train step: K3 shapes {shapes}")

        # restore step 3's checkpoint (bit-equal) and resume steps 4 .. 6 from it
        tree_like = {"p": tf.param_tree(params), "o": opt_state}
        t0 = time.perf_counter()
        restored, extra = mgr.restore(3, tree_like)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        bit_equal = all(torch.equal(a.cpu(), b) for a, b in zip(leaves(restored), saved))
        if not bit_equal or extra != {"loss": losses[2]}:
            raise AssertionError("train step: the restored checkpoint is not the saved state")
        del saved
        with torch.no_grad():
            for p, a in zip(leaves(tf.param_tree(params)), leaves(restored["p"])):
                p.copy_(a)
        opt_state = restored["o"]
        del restored
        resumed = []
        for _ in range(3):
            params, opt_state, m = step_fn(params, opt_state, batch)
            resumed.append(float(m["loss"]))
        resume_rel = max(abs(a - b) / abs(b) for a, b in zip(resumed, losses[3:6]))
        if resume_rel > 1e-4:
            raise AssertionError(f"train step: resumed losses {resumed} vs {losses[3:6]}")
        ckpt_bytes = dir_bytes(os.path.join(workdir, "ckpt"))
        del params, opt_state, batch, tree_like
        gc.collect()
        torch.cuda.empty_cache()
        card_cpu = train_card_vs_cpu()
        # K3-bwd's float32 path at the check's layer shape (15 heads, S 1100), seeded
        gen = torch.Generator(device="cuda").manual_seed(6)
        q, k, v, do = (torch.randn(cfg.n_heads, 1100, cfg.head_dim, generator=gen, device="cuda")
                       for _ in range(4))
        check_timing = time_flash_bwd_kernel(
            q, k, v, do, "6b card-vs-CPU check: smollm-360m layer in float32, 1 x 1100 tokens")
        del q, k, v, do
        entry = train_entry_point(workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    p50_ms = float(np.percentile(times, 50))
    tokens = global_batch * S
    N = cfg.num_params()
    rec = {"phase": "train_step", "arch": "smollm-360m", "n_layers": L, "d_model": cfg.d_model,
           "dtype": "bfloat16", "remat": cfg.remat, "q_chunk": cfg.q_chunk, "S": S,
           "global_batch": global_batch, "num_micro": num_micro,
           "reduced": {"global_batch": f"256 -> {global_batch}"},
           "optimizer": {"lr": 1e-3, "warmup_steps": 2, "total_steps": 10},
           "losses": losses, "step_ms": times, "step_p50_ms": p50_ms,
           "tokens_per_s": tokens / (p50_ms * 1e-3), "N": N, "T": tokens,
           "model_flops_share_of_bf16_peak": 6.0 * N * tokens / (p50_ms * 1e-3) / PEAK_BF16_FLOPS,
           "k3_launches_per_step": per_step_fwd, "k3_bwd_launches_per_step": per_step_bwd,
           "launch_formula": "K3 2 x layers x num_micro (remat), K3-bwd layers x num_micro",
           "k3_shapes": {f"{BH}x{s}x{D}": n for (_, BH, s, D, _), n in shapes.items()},
           "peak_device_bytes": peak, "checkpoint_bytes": ckpt_bytes, "save_s": save_s,
           "restore_s": restore_s, "restore_bit_equal": bit_equal, "resumed_losses": resumed,
           "resume_max_rel_err": resume_rel, "card_vs_cpu": card_cpu, "entry_point": entry}
    emit(rec)
    # K3 forward at the step's layer shape, seeded (its time does not depend on the values)
    gen = torch.Generator(device="cuda").manual_seed(4)
    q, k, v = (torch.randn(B_micro * cfg.n_heads, S, cfg.head_dim, generator=gen, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    timing = time_flash_kernel(q, k, v, f"train_4k layer: smollm-360m, {B_micro} x {S} tokens")
    return {"launches": launches["flash_attention"],
            "bwd_launches": launches["flash_attention_bwd"],
            "instances": [{**timing, "launches": launches["flash_attention"]}],
            "check_bwd": {**check_timing, "launches": card_cpu["k3_bwd_launches"]}}


# ------------------------------------------------------------ MoE and MLA


class RecordMoE:
    """Counts, for every call of ``moe.moe_apply`` while the model runs, the
    (token, k) assignments dropped at the call's capacity, and keeps each
    call's top-k experts with ``keep_routes``.  The routing is recomputed
    with the port's own ``moe.route`` on the call's input; the call itself
    goes through unchanged."""

    def __init__(self, keep_routes: bool = False):
        self.keep_routes = keep_routes
        self.dropped, self.assignments, self.routes = [], [], []

    def __enter__(self):
        from repro_torch.models import moe

        self._orig = moe.moe_apply

        def recording(params, cfg, x, *, capacity_factor=0.0):
            T = x.shape[0] * x.shape[1]
            C = moe.capacity(cfg, T, capacity_factor)
            with torch.no_grad():
                _, _, top_e = moe.route(params, cfg, x.reshape(T, -1))
                rank = moe._ranks_within_expert(top_e.reshape(-1), cfg.num_experts)
            self.dropped.append(int((rank >= C).sum()))
            self.assignments.append(T * cfg.top_k)
            if self.keep_routes:
                self.routes.append(top_e.cpu())
            return self._orig(params, cfg, x, capacity_factor=capacity_factor)

        moe.moe_apply = recording
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe.moe_apply = self._orig
        return False


def moe_mla_prefill_32k(arch: str, cfg, params, S: int, B: int) -> dict:
    """6c (a): one warm-up, then one timed prefill of B x S seeded tokens
    into a bf16 cache: K3 once a layer, checked at the first and last layer
    against the plain version, the dropped-assignment share, and K3 / plain
    / SDPA at the layer's shape."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models import transformer as tf
    from repro_torch.serve import make_prefill_fn

    L = cfg.n_layers
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen, device="cuda")
    cache = tf.make_cache(cfg, B, S, dtype=torch.bfloat16)
    prefill = make_prefill_fn(cfg)
    prefill(params, tokens[:, :2048], cache)  # warm-up: cuBLAS plans, K3's first launch
    torch.cuda.reset_peak_memory_stats()
    with RecordAttention(keep=(0, L - 1)) as rec, RecordMoE() as moe_rec:
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(params, tokens, cache)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = ops.KERNEL_LAUNCHES["flash_attention"]
    peak = torch.cuda.max_memory_allocated()
    if launches != L:
        raise AssertionError(f"6c {arch} prefill_32k: K3 launched {launches} times for {L} "
                             "layers")
    if logits.shape != (B, cfg.vocab) or not torch.isfinite(logits).all():
        raise AssertionError(f"6c {arch} prefill_32k: logits {tuple(logits.shape)} not finite")
    last = next(iter(cache.values()))[:, :, S - 1]
    if not (last.reshape(L, -1).abs().sum(-1) > 0).all():
        raise AssertionError(f"6c {arch} prefill_32k: the cache's last position was not written")
    if len(moe_rec.dropped) != cfg.n_scan_layers:
        raise AssertionError(f"6c {arch}: {len(moe_rec.dropped)} MoE calls for "
                             f"{cfg.n_scan_layers} MoE layers")
    layer_err, layer_agree = {}, {}
    for i, (q, k, v, out) in sorted(rec.calls.items()):
        q, k, v, out = (fold_bhsd(t) for t in (q, k, v, out))
        scale = 1.0 / q.shape[-1] ** 0.5
        want = ref.flash_attention_ref(q, k, v, causal=True, scale=scale)
        layer_err[f"layer_{i}"] = float((out.float() - want.float()).abs().max())
        want32 = ref.flash_attention_ref(q.float(), k.float(), v.float(), causal=True,
                                         scale=scale)
        layer_agree[f"layer_{i}"] = ref.bf16_agreement(out, want32)
    if max(layer_err.values()) > K3_TOL[torch.bfloat16] or max(layer_agree.values()) > 1.0:
        raise AssertionError(f"6c {arch} prefill_32k: K3 vs plain {layer_err}, bf16 agreement "
                             f"{layer_agree}")
    q, k, v, _ = (fold_bhsd(t) for t in rec.calls[0])
    shapes = dict(rec.shapes)
    del logits, cache, rec
    if shapes != {(torch.bfloat16, q.shape[0], S, q.shape[2], v.shape[2]): launches}:
        raise AssertionError(f"6c {arch} prefill_32k: K3 launches by shape {shapes}")
    timing = time_flash_kernel(q, k, v, f"prefill_32k layer 0: {arch}, S={S}")
    dropped = moe_rec.dropped
    rec = {"seconds": seconds, "prefill_tokens_per_s": B * S / seconds, "k3_launches": launches,
           "k3_vs_plain_max_abs_err": layer_err, "k3_vs_plain_bf16_agreement": layer_agree,
           "capacity_factor": cfg.moe.capacity_factor,
           "dropped_share": sum(dropped) / sum(moe_rec.assignments),
           "dropped_share_by_layer": [d / a for d, a in zip(dropped, moe_rec.assignments)],
           "peak_device_bytes": peak}
    return {"record": rec, "launches": launches, "max_abs_err": max(layer_err.values()),
            "instance": {**timing, "launches": launches}}


def moe_mla_engine(arch: str, cfg, params, n_requests: int, max_new: int) -> dict:
    """6c (b): ``ServeEngine`` with 4 slots, max_seq 4096 and a bf16 cache on
    seeded requests; decode steps timed by CUDA events."""
    from repro_torch.kernels import ops
    from repro_torch.serve import Request, ServeEngine

    eng = ServeEngine(cfg, params, slots=4, max_seq=4096, cache_dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    reqs = [Request(u, rng.integers(0, cfg.vocab, int(n)).astype(np.int32), max_new_tokens=max_new)
            for u, n in enumerate(rng.integers(1100, 4001, n_requests))]
    prefill_s, decode_events = [], []
    inner_prefill, inner_decode = eng._prefill, eng._decode

    def prefill(*a):
        t0 = time.perf_counter()
        res = inner_prefill(*a)
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
        return res

    def decode(*a):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        res = inner_decode(*a)
        end.record()
        decode_events.append((start, end))
        return res

    eng._prefill, eng._decode = prefill, decode
    for r in reqs:
        eng.submit(r)
    with RecordAttention() as rec:
        ops.reset_launches()
        t0 = time.perf_counter()
        stats = dict(eng.run())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.KERNEL_LAUNCHES["flash_attention"]
    dec = np.array([s.elapsed_time(e) for s, e in decode_events])
    buckets = [eng._prompt_bucket(len(r.prompt)) for r in reqs]
    want_launches = cfg.n_layers * sum(b > cfg.q_chunk for b in buckets)
    if stats["completed"] != n_requests or launches != want_launches or launches <= 0 \
            or sum(rec.shapes.values()) != launches:
        raise AssertionError(f"6c {arch} engine: stats {stats}, K3 launches {launches} (want "
                             f"{want_launches}), by shape {rec.shapes}")
    for r in reqs:
        if len(r.tokens_out) != max_new or not all(0 <= t < cfg.vocab for t in r.tokens_out):
            raise AssertionError(f"6c {arch} engine: request {r.uid} tokens {r.tokens_out}")
    cache_bytes = sum(c[0, 0, 0].numel() * c.element_size() for c in eng.cache.values())
    record = {"slots": 4, "max_seq": 4096, "cache_dtype": "bfloat16", "requests": n_requests,
              "prompt_lengths": [len(r.prompt) for r in reqs], "buckets": buckets,
              "max_new_tokens": max_new, "stats": stats, "wall_s": wall,
              "prefill_s": float(sum(prefill_s)),
              "prefill_tokens_per_s": stats["prefill_tokens"] / sum(prefill_s),
              "decode_steps_per_s": 1e3 * len(dec) / dec.sum(),
              "decode_step_p50_ms": float(np.percentile(dec, 50)),
              "decode_step_p99_ms": float(np.percentile(dec, 99)),
              "k3_launches": launches,
              "cache_bytes_per_token_per_layer": cache_bytes,
              "k3_launches_by_shape": {f"{BH}x{S}x{D}->{Dv}": n
                                       for (_, BH, S, D, Dv), n in rec.shapes.items()}}
    del eng
    return {"record": record, "launches": launches, "shapes": dict(rec.shapes)}


def moe_mla_card_vs_cpu(arch: str, cfg, n_layers: int, prompt_len: int = 1100) -> dict:
    """6c (c): the first ``n_layers`` layers at full width in float32, one
    request through the engine on the card (K3 float32) and on the CPU
    (plain path): the first greedy token, the last logits and the
    (token, expert) routes."""
    import copy
    import dataclasses

    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tf
    from repro_torch.serve import Request, ServeEngine

    cfg_c = dataclasses.replace(cfg, n_layers=n_layers, param_dtype="float32",
                                compute_dtype="float32")
    gpu_params = tf.init(cfg_c, seed=0)
    cpu_params = copy.deepcopy(gpu_params).to("cpu")
    prompt = np.random.default_rng(1).integers(0, cfg.vocab, prompt_len).astype(np.int32)
    first, last_logits, routes, secs = {}, {}, {}, {}
    for name, p in (("cuda", gpu_params), ("cpu", cpu_params)):
        e = ServeEngine(cfg_c, p, slots=1, max_seq=4096)
        inner = e._prefill

        def keep_logits(*a, name=name, inner=inner):
            lg, c = inner(*a)
            last_logits[name] = lg[0].float().cpu()
            return lg, c

        e._prefill = keep_logits
        r = Request(0, prompt, max_new_tokens=1)
        e.submit(r)
        t0 = time.perf_counter()
        with RecordMoE(keep_routes=True) as moe_rec, RecordAttention() as rec:
            ops.reset_launches()
            e.run()
            launches = ops.KERNEL_LAUNCHES["flash_attention"]
        secs[name] = time.perf_counter() - t0
        first[name] = r.tokens_out[0]
        routes[name] = moe_rec.routes
        if name == "cuda":
            shapes = dict(rec.shapes)
            if launches != n_layers or sum(shapes.values()) != n_layers:
                raise AssertionError(f"6c {arch} card check: K3 launched {launches} times, "
                                     f"by shape {shapes}")
    del gpu_params, cpu_params
    K = cfg.moe.top_k
    # per call, the card's (token, expert) routes that the CPU's top-k holds too
    same = [(a[:, :, None] == b[:, None, :]).any(-1)
            for a, b in zip(routes["cuda"], routes["cpu"])]
    share = float(sum(m.sum() for m in same) / sum(m.numel() for m in same))
    same = [float(m.float().mean()) for m in same]
    gap = float((last_logits["cuda"] - last_logits["cpu"]).abs().max())
    record = {"reduced": {"n_layers": f"{cfg.n_layers} -> {n_layers}"}, "dtype": "float32",
              "prompt": prompt_len, "first_token": first, "last_logits_max_abs_gap": gap,
              "tol": 1e-3, "route_agreement": share, "route_agreement_by_layer": same,
              "route_agreement_limit": 0.999, "top_k": K, "seconds": secs}
    if first["cuda"] != first["cpu"] or gap > 1e-3 or share < 0.999:
        raise AssertionError(f"6c {arch} card vs CPU: {record}")
    return {"record": record, "shapes": shapes}


def phase_moe_mla_serving(archs=("deepseek-moe-16b", "deepseek-v2-lite-16b"), S: int = 32_768,
                          B: int = 1, n_requests: int = 8, max_new: int = 32,
                          cpu_layers: int = 3) -> dict:
    from repro_torch.configs import get_config, serving_config
    from repro_torch.models import transformer as tf

    launches, instances, max_err = 0, [], 0.0
    for arch in archs:
        gc.collect()
        torch.cuda.empty_cache()
        cfg = serving_config(get_config(arch), "prefill")
        t0 = time.perf_counter()
        params = tf.init(cfg, seed=0)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        param_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
        pre = moe_mla_prefill_32k(arch, cfg, params, S, B)
        eng = moe_mla_engine(arch, cfg, params, n_requests, max_new)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        check = moe_mla_card_vs_cpu(arch, cfg, cpu_layers)
        emit({"phase": "moe_mla_serving", "arch": arch, "n_layers": cfg.n_layers,
              "attention": cfg.attention, "d_model": cfg.d_model, "dtype": "bfloat16",
              "q_chunk": cfg.q_chunk, "num_params": cfg.num_params(),
              "num_active_params": cfg.num_active_params(), "param_bytes": param_bytes,
              "init_s": init_s, "prefill_32k": {"S": S, "B": B, **pre["record"],
                                                "reduced": {"global_batch": f"32 -> {B}"}},
              "engine": eng["record"], "card_vs_cpu": check["record"]})
        launches += pre["launches"] + eng["launches"] + sum(check["shapes"].values())
        max_err = max(max_err, pre["max_abs_err"])
        instances.append(pre["instance"])
        # K3 at each shape the engine's prefills and the float32 check ran,
        # seeded (the kernel's time does not depend on the values)
        gen = torch.Generator(device="cuda").manual_seed(2)
        for (dtype, BH, Sb, D, Dv), n in sorted({**eng["shapes"], **check["shapes"]}.items(),
                                                key=lambda kv: (str(kv[0][0]), -kv[0][2])):
            q, k = (torch.randn(BH, Sb, D, generator=gen, device="cuda", dtype=dtype)
                    for _ in range(2))
            v = torch.randn(BH, Sb, Dv, generator=gen, device="cuda", dtype=dtype)
            where = "card-vs-CPU check" if dtype == torch.float32 else "engine bucket"
            timing = time_flash_kernel(q, k, v, f"6c {where}: {arch}, S={Sb}")
            instances.append({**timing, "launches": n})
    return {"launches": launches, "max_abs_err": max_err, "instances": instances}


# ----------------------------------------------------- MoE and MLA training


def moe_mla_train_steps(arch: str, cfg, S: int, global_batch: int, num_micro: int,
                        steps: int) -> dict:
    """6d (a): ``make_train_step(lm_loss_fn(cfg), AdamWConfig(lr=1e-3,
    warmup_steps=2, total_steps=10), num_micro)`` on one seeded batch,
    repeated: a warm-up step (its routes give the dropped share), then
    ``steps`` timed steps (CUDA events) with K3's calls counted by shape."""
    from repro_torch.data.synthetic import token_batch
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tf
    from repro_torch.train.optimizer import AdamWConfig, init_state
    from repro_torch.train.train_step import lm_loss_fn, make_train_step

    L = cfg.n_layers
    t0 = time.perf_counter()
    params = tf.init(cfg, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    param_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    opt_state = init_state(params)
    step_fn = make_train_step(lm_loss_fn(cfg), AdamWConfig(lr=1e-3, warmup_steps=2,
                                                           total_steps=10), num_micro=num_micro)
    toks, labels = token_batch(global_batch, S, cfg.vocab, seed=0)
    batch = {"tokens": torch.from_numpy(toks).cuda(), "labels": torch.from_numpy(labels).cuda()}
    losses, auxes = [], []

    def step():
        nonlocal params, opt_state
        params, opt_state, m = step_fn(params, opt_state, batch)
        losses.append(float(m["loss"]))  # waits for the step
        auxes.append(float(m["aux_loss"]))

    with RecordMoE() as moe_rec:
        step()  # warm-up: step 1, cuBLAS plans and the kernel libraries
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    with RecordAttention() as rec:
        ops.reset_launches()
        for _ in range(steps):  # steps 2 .. steps + 1
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            step()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        launches = dict(ops.KERNEL_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    del params, opt_state, batch
    gc.collect()
    torch.cuda.empty_cache()
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"6d {arch}: losses {losses}")
    if not all(np.isfinite(a) and a > 0 for a in auxes):
        raise AssertionError(f"6d {arch}: aux losses {auxes}")
    per_step_fwd = launches["flash_attention"] / steps
    per_step_bwd = launches["flash_attention_bwd"] / steps
    want_fwd, want_bwd = 2 * L * num_micro, L * num_micro  # remat: each forward twice
    if per_step_fwd != want_fwd or per_step_bwd != want_bwd:
        raise AssertionError(f"6d {arch}: K3 {per_step_fwd} / K3-bwd {per_step_bwd} launches a "
                             f"step, want {want_fwd} / {want_bwd}")
    B_micro = global_batch // num_micro
    D, Dv = ((cfg.mla_qk_nope_head_dim + cfg.mla_qk_rope_head_dim, cfg.mla_v_head_dim)
             if cfg.attention == "mla" else (cfg.head_dim, cfg.head_dim))
    shape = (torch.bfloat16, B_micro * cfg.n_heads, S, D, Dv)
    if rec.shapes != {shape: launches["flash_attention"]}:
        raise AssertionError(f"6d {arch}: K3 shapes {rec.shapes}")
    p50_ms = float(np.percentile(times, 50))
    tokens = global_batch * S
    N_active = cfg.num_active_params()
    record = {"losses": losses, "aux_losses": auxes, "step_ms": times, "step_p50_ms": p50_ms,
              "step_p99_ms": float(np.percentile(times, 99)),
              "tokens_per_s": tokens / (p50_ms * 1e-3), "T": tokens, "N": cfg.num_params(),
              "N_active": N_active,
              "model_flops_share_of_bf16_peak": 6.0 * N_active * tokens / (p50_ms * 1e-3)
              / PEAK_BF16_FLOPS,
              "param_bytes": param_bytes, "init_s": init_s, "peak_device_bytes": peak,
              "capacity_factor": cfg.moe.capacity_factor,
              "dropped_share_step1": sum(moe_rec.dropped) / sum(moe_rec.assignments),
              "k3_launches_per_step": per_step_fwd, "k3_bwd_launches_per_step": per_step_bwd,
              "launch_formula": "K3 2 x layers x num_micro (remat), K3-bwd layers x num_micro",
              "k3_shapes": {f"{BH}x{s_}x{d}->{dv}": n for (_, BH, s_, d, dv), n
                            in rec.shapes.items()}}
    return {"record": record, "launches": launches["flash_attention"],
            "bwd_launches": launches["flash_attention_bwd"], "shape": shape}


def moe_mla_train_card_vs_cpu(arch: str, cfg, n_layers: int, S: int) -> dict:
    """6d (b): the grads of one train step of ``arch``'s first ``n_layers``
    layers (1 dense + the rest MoE) at full width in float32, one sequence
    of S seeded tokens, on the card (K3 and K3-bwd float32, MLA's at (192,
    128)) and on the CPU (the plain versions), from the same params.  The
    (token, expert) routes are compared first, as 6c (c) does: where a
    near tie in the float32 router flips one, the weights and router column
    of every expert a flipped assignment touches are left out of the grad
    check (and named).  Then loss within 1e-5 relative (aux too, unless a
    top-1 route flipped), every grad tensor within 1e-3 of the CPU's
    largest entry, the grad norm within 1e-4 relative."""
    import copy
    import dataclasses

    from repro_torch.common.tree import flatten
    from repro_torch.data.synthetic import token_batch
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tf
    from repro_torch.train.optimizer import global_norm
    from repro_torch.train.train_step import _accumulate_grads, lm_loss_fn

    cfg_c = dataclasses.replace(cfg, n_layers=n_layers, param_dtype="float32",
                                compute_dtype="float32")
    gpu_params = tf.init(cfg_c, seed=0)
    cpu_params = copy.deepcopy(gpu_params).to("cpu")
    names = [n for n, _ in flatten(tf.param_tree(cpu_params))]
    toks, labels = token_batch(1, S, cfg.vocab, seed=7)
    batch = {"tokens": toks, "labels": labels}
    out, secs = {}, {}
    for name, params in (("cuda", gpu_params), ("cpu", cpu_params)):
        t0 = time.perf_counter()
        with RecordMoE(keep_routes=True) as moe_rec, RecordAttention() as rec:
            ops.reset_launches()
            loss, grads, aux = _accumulate_grads(lm_loss_fn(cfg_c), params, batch, 1)
            gnorm = float(global_norm(grads))
            launches = dict(ops.KERNEL_LAUNCHES)
        secs[name] = time.perf_counter() - t0
        out[name] = (float(loss), float(aux), [g.cpu() for g in grads], gnorm,
                     moe_rec.routes[:cfg_c.n_scan_layers])  # the forward's calls, in order
        if name == "cuda":
            card_launches, shapes = launches, dict(rec.shapes)
        del grads
    del gpu_params, cpu_params
    (lg, ag, gg, ng, rg), (lc, ac, gc_, nc, rc) = out["cuda"], out["cpu"]
    # routes first: the experts a flipped (token, k) assignment touches, per MoE layer
    flipped, agree, top1_flips = {}, [], 0
    for layer, (a, b) in enumerate(zip(rg, rc)):
        same = (a[:, :, None] == b[:, None, :]).any(-1)
        agree.append(float(same.float().mean()))
        top1_flips += int((a[:, 0] != b[:, 0]).sum())
        experts = set(a[~same].tolist()) | set(b[~(b[:, :, None] == a[:, None, :]).any(-1)]
                                               .tolist())
        if experts:
            flipped[layer] = sorted(experts)
    share = float(np.mean(agree))
    held, grad_err = [], 0.0
    for n, g, c in zip(names, gg, gc_):
        parts = n.split("/")
        if parts[0] == "blocks" and int(parts[1]) in flipped and parts[2] == "moe" \
                and parts[3] in ("w_gate", "w_up", "w_down", "router"):
            ex = flipped[int(parts[1])]
            keep = torch.ones(c.shape[-1] if parts[3] == "router" else c.shape[0],
                              dtype=torch.bool)
            keep[ex] = False
            g, c = (g[:, keep], c[:, keep]) if parts[3] == "router" else (g[keep], c[keep])
            held.append(n)
        grad_err = max(grad_err, float((g - c).abs().max()) / float(c.abs().max()))
    record = {"reduced": {"n_layers": f"{cfg.n_layers} -> {n_layers}",
                          "dtype": "bfloat16 -> float32", "global_batch": "256 -> 1",
                          "S": f"4096 -> {S}"},
              "tokens": S, "num_micro": 1, "q_chunk": cfg_c.q_chunk, "remat": cfg_c.remat,
              "route_agreement": share, "route_agreement_by_layer": agree,
              "route_agreement_limit": 0.999, "top1_flips": top1_flips,
              "flipped_experts_by_moe_layer": {str(k): v for k, v in flipped.items()},
              "grads_held_without_flipped_experts": held,
              "loss_cuda": lg, "loss_cpu": lc, "loss_rel_err": abs(lg - lc) / abs(lc),
              "aux_cuda": ag, "aux_cpu": ac, "aux_rel_err": abs(ag - ac) / abs(ac),
              "grad_max_rel_err": grad_err, "grad_norm_cuda": ng, "grad_norm_cpu": nc,
              "grad_norm_rel_err": abs(ng - nc) / nc, "seconds": secs,
              "k3_launches": card_launches["flash_attention"],
              "k3_bwd_launches": card_launches["flash_attention_bwd"],
              "k3_shapes": {f"{BH}x{s_}x{d}->{dv}": n for (_, BH, s_, d, dv), n
                            in shapes.items()}}
    want_k3 = 2 * n_layers if cfg_c.remat else n_layers
    if not (share >= 0.999 and record["loss_rel_err"] <= 1e-5 and grad_err <= 1e-3
            and record["grad_norm_rel_err"] <= 1e-4
            and (top1_flips > 0 or record["aux_rel_err"] <= 1e-5)
            and record["k3_launches"] == want_k3 and record["k3_bwd_launches"] == n_layers):
        raise AssertionError(f"6d {arch} card vs CPU: {record}")
    return {"record": record, "shapes": shapes}


def phase_moe_mla_training(archs=("deepseek-moe-16b", "deepseek-v2-lite-16b"), S: int = 4096,
                           global_batch: int = 16, num_micro: int = 4, steps: int = 4,
                           n_layers: int = 4, cpu_layers: int = 3, cpu_tokens: int = 1100) -> dict:
    import dataclasses

    from repro_torch.configs import get_config, training_config

    out = {"launches": 0, "bwd_launches": 0, "instances": [], "bwd": {}, "bwd_max_abs_err": 0.0}
    for arch in archs:
        gc.collect()
        torch.cuda.empty_cache()
        t_arch = time.perf_counter()
        full = training_config(get_config(arch))
        cfg = dataclasses.replace(full, n_layers=n_layers)
        train = moe_mla_train_steps(arch, cfg, S, global_batch, num_micro, steps)
        check = moe_mla_train_card_vs_cpu(arch, full, cpu_layers, cpu_tokens)
        emit({"phase": "moe_mla_training", "arch": arch, "attention": cfg.attention,
              "d_model": cfg.d_model, "n_layers": n_layers, "dtype": "bfloat16",
              "remat": cfg.remat, "q_chunk": cfg.q_chunk, "S": S, "global_batch": global_batch,
              "num_micro": num_micro, "timed_steps": steps,
              "reduced": {"n_layers": f"{full.n_layers} -> {n_layers} (1 dense + "
                                      f"{n_layers - full.moe.first_k_dense} MoE)",
                          "global_batch": f"256 -> {global_batch}"},
              "optimizer": {"lr": 1e-3, "warmup_steps": 2, "total_steps": 10},
              **train["record"], "card_vs_cpu": check["record"],
              "seconds": time.perf_counter() - t_arch})
        n_check = sum(check["shapes"].values())
        out["launches"] += train["launches"] + n_check
        out["bwd_launches"] += train["bwd_launches"] + check["record"]["k3_bwd_launches"]
        # K3 at the step's layer shape and at the check's, seeded (its time
        # does not depend on the values); K3-bwd at the check's shape in
        # float32 (the step's bf16 shape is timed in 2d)
        gen = torch.Generator(device="cuda").manual_seed(8)
        for (dtype, BH, Sb, D, Dv), n, what in ((train["shape"], train["launches"], "step"),
                                                 *((k, v, "card-vs-CPU check")
                                                   for k, v in check["shapes"].items())):
            q, k = (torch.randn(BH, Sb, D, generator=gen, device="cuda", dtype=dtype)
                    for _ in range(2))
            v = torch.randn(BH, Sb, Dv, generator=gen, device="cuda", dtype=dtype)
            timing = time_flash_kernel(q, k, v, f"6d {what}: {arch}, S={Sb}")
            out["instances"].append({**timing, "launches": n})
            if dtype == torch.float32:
                do = torch.randn(BH, Sb, Dv, generator=gen, device="cuda", dtype=dtype)
                bwd = time_flash_bwd_kernel(q, k, v, do, f"6d card-vs-CPU check: {arch} layer "
                                                         f"in float32, 1 x {Sb} tokens")
                out["bwd"][arch] = {"step": train["bwd_launches"],
                                    "check": {**bwd, "launches": check["record"]["k3_bwd_launches"]}}
                out["bwd_max_abs_err"] = max(out["bwd_max_abs_err"], bwd["max_abs_err"])
                del do
            del q, k, v
    return out



def gnn_molecule_cell(B: int = 128, n: int = 30, E: int = 64, t_max: int = 256) -> dict:
    """6e (a): ``random_molecule_batch(B, n, E)``, each molecule's first
    t_max triplets (``GNNArch.smoke``'s cut), -1 padded; graph targets."""
    from repro_torch.data.synthetic import random_molecule_batch
    from repro_torch.models.dimenet import build_triplets

    t0 = time.perf_counter()
    mols = random_molecule_batch(B, n, E, seed=0)
    t_in, t_out = np.full((B, t_max), -1, np.int32), np.full((B, t_max), -1, np.int32)
    found = []
    for b in range(B):
        ti, to = build_triplets(mols["edge_index"][b], n)
        found.append(len(ti))
        t_in[b, :min(t_max, len(ti))], t_out[b, :min(t_max, len(to))] = ti[:t_max], to[:t_max]
    batch = {"positions": mols["positions"], "edge_index": mols["edge_index"], "t_in": t_in,
             "t_out": t_out, "z": mols["z"], "y": mols["y"]}
    return {"batch": batch, "host_s": time.perf_counter() - t0,
            "info": {"graphs": B, "nodes": B * n,
                     "edges": int((mols["edge_index"][:, 0] >= 0).sum()),
                     "triplets": int((t_in >= 0).sum()), "t_max": t_max,
                     "triplets_a_molecule": [min(found), max(found)],
                     "molecules_cut_at_t_max": int(sum(f > t_max for f in found))}}


def gnn_full_graph_cell(n: int = 2708, E: int = 10556, d_feat: int = 1433,
                        cap: int = 8) -> dict:
    """6e (b): ``power_law_graph(n, E, d_feat)`` (Cora's sizes), triplets
    capped at ``cap`` an edge and padded to E x cap; node targets, every node
    in ``node_mask`` (the graph has no padding)."""
    from repro_torch.data.synthetic import power_law_graph
    from repro_torch.models.dimenet import build_triplets

    t0 = time.perf_counter()
    g = power_law_graph(n, E, d_feat=d_feat, seed=0)
    ti, to = build_triplets(g["edge_index"], n, max_in_per_edge=cap)
    T = E * cap
    t_in, t_out = np.full(T, -1, np.int32), np.full(T, -1, np.int32)
    t_in[:len(ti)], t_out[:len(to)] = ti, to
    y = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    batch = {"positions": g["positions"], "edge_index": g["edge_index"], "t_in": t_in,
             "t_out": t_out, "features": g["features"], "node_mask": np.ones(n, bool), "y": y}
    return {"batch": batch, "host_s": time.perf_counter() - t0,
            "info": {"nodes": n, "edges": E, "d_feat": d_feat, "triplets": len(ti),
                     "t_padded": T, "triplet_cap": cap}}


def gnn_minibatch_lane(n: int = 232_965, E: int = 114_615_892, batch_nodes: int = 1024,
                       fanout=(15, 10), n_max: int = 16_384, e_max: int = 16_384,
                       t_max: int = 32_768) -> dict:
    """6e (c): one minibatch_lg lane (``families.py``'s layout): the Reddit-
    sized ``power_law_graph`` -> ``CSRGraph``; ``sample_subgraph`` of
    ``batch_nodes`` seeded seeds at ``fanout`` into n_max / e_max;
    ``build_triplets(max_triplets=t_max)``, -1 padded; z drawn per global
    node in [1, 10); one graph target.  Host seconds by stage."""
    from repro_torch.data.sampler import CSRGraph, sample_subgraph
    from repro_torch.data.synthetic import power_law_graph
    from repro_torch.models.dimenet import build_triplets

    secs = {}
    t0 = time.perf_counter()
    g = power_law_graph(n, E, seed=0)
    secs["power_law_graph"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    csr = CSRGraph.from_edge_index(g.pop("edge_index"), n)
    secs["csr"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rng = np.random.default_rng(2)
    z_global = rng.integers(1, 10, n).astype(np.int32)
    seeds = rng.choice(n, batch_nodes, replace=False)
    sub = sample_subgraph(csr, seeds, tuple(fanout), rng=rng, n_max=n_max, e_max=e_max)
    secs["sample_subgraph"] = time.perf_counter() - t0
    max_degree = int(np.diff(csr.indptr).max())
    del csr
    t0 = time.perf_counter()
    ti, to = build_triplets(sub["edge_index"], n_max, max_triplets=t_max)
    secs["build_triplets"] = time.perf_counter() - t0
    nodes = sub["nodes"]
    real = nodes >= 0
    t_in, t_out = np.full(t_max, -1, np.int32), np.full(t_max, -1, np.int32)
    t_in[:len(ti)], t_out[:len(to)] = ti, to
    batch = {"positions": np.where(real[:, None], g["positions"][nodes.clip(0)], 0)[None],
             "edge_index": sub["edge_index"][None], "t_in": t_in[None], "t_out": t_out[None],
             "z": np.where(real, z_global[nodes.clip(0)], -1).astype(np.int32)[None],
             "y": rng.standard_normal(1).astype(np.float32)}
    return {"batch": batch, "host_s": sum(secs.values()), "host_s_by_stage": secs,
            "info": {"graph_nodes": n, "graph_edges": E, "graph_max_out_degree": max_degree,
                     "seeds": batch_nodes, "fanout": list(fanout), "nodes": int(real.sum()),
                     "edges": int((sub["edge_index"][0] >= 0).sum()), "triplets": len(ti),
                     "n_max": n_max, "e_max": e_max, "t_max": t_max}}


def gnn_train_cell(cfg, batch: dict, steps: int) -> dict:
    """6e: ``make_train_step(dimenet_loss_fn(cfg), AdamWConfig(lr=1e-3,
    warmup_steps=2, total_steps=20))`` from seeded params on the card, one
    batch repeated: a warm-up step, then ``steps`` timed steps (CUDA
    events), peak device bytes, losses finite and falling."""
    from repro_torch.common.tree import leaves
    from repro_torch.models import dimenet
    from repro_torch.train.optimizer import AdamWConfig, init_state
    from repro_torch.train.train_step import dimenet_loss_fn, make_train_step

    params = dimenet.init(cfg, seed=0, device="cuda")
    opt_state = init_state(params)
    step_fn = make_train_step(dimenet_loss_fn(cfg), AdamWConfig(lr=1e-3, warmup_steps=2,
                                                                total_steps=20))
    card = to_card(batch)
    losses, norms = [], []

    def step():
        nonlocal params, opt_state
        params, opt_state, m = step_fn(params, opt_state, card)
        losses.append(float(m["loss"]))  # waits for the step
        norms.append(float(m["grad_norm"]))

    step()  # warm-up: step 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = event_ms(step, steps)
    peak = torch.cuda.max_memory_allocated()
    # At init the losses are 1e10-1e32 (in the reference too) and the first
    # steps swing by orders of magnitude, the reference's as well, so the
    # last loss need not be the lowest: the loss must fall below step 1's at
    # some step.  An inf grad norm (its float32
    # sum of squares overflows, as the reference's does on molecules) makes
    # the clip zero every grad: the step is weight decay alone, below a bf16
    # param's rounding, and the loss cannot move; that passes only when
    # every norm is inf.
    clipped_to_zero = not any(np.isfinite(norms))
    if not (all(np.isfinite(losses)) and (min(losses[1:]) < losses[0] or clipped_to_zero)):
        raise AssertionError(f"6e: losses {losses}, grad norms {norms}")
    record = {"losses": losses, "grad_norms": norms, "update_clipped_to_zero": clipped_to_zero,
              "step_ms": ms.tolist(),
              "step_p50_ms": float(np.median(ms)),
              "peak_device_bytes": peak, "params": sum(t.numel() for t in leaves(params)),
              "param_bytes": sum(t.numel() * t.element_size() for t in leaves(params))}
    return {"record": record, "step_fn": step_fn, "params": params, "opt_state": opt_state,
            "batch": card}


def gnn_repeat_bits(cell: dict, steps: int = 2) -> dict:
    """6e: ``steps`` steps run twice from one saved state: params and AdamW
    moments must be the same bits."""
    from repro_torch.common.tree import leaves

    saved_p, saved_s = clone_tree(cell["params"]), clone_tree(cell["opt_state"])
    runs = []
    for _ in range(2):
        p, s = clone_tree(saved_p), clone_tree(saved_s)
        for _ in range(steps):
            p, s, m = cell["step_fn"](p, s, cell["batch"])
        runs.append((leaves(p) + leaves(s["m"]) + leaves(s["v"]), float(m["loss"])))
    differ = sum(not torch.equal(a, b) for a, b in zip(runs[0][0], runs[1][0]))
    if differ or runs[0][1] != runs[1][1]:
        raise AssertionError(f"6e: {differ} tensors differ between two runs from one state")
    return {"steps": steps, "tensors": len(runs[0][0]), "bit_equal": True, "loss": runs[0][1]}


def gnn_card_vs_cpu(cfg, batch: dict) -> dict:
    """6e: the grads of one step at full width in float32, seeded params on
    the card and the same params on the CPU; ``within_limits``: loss within
    1e-5 relative, each grad within 1e-3 of the CPU's largest entry, the
    grad norm within 1e-4 relative.  The norm is summed in float64: at init the molecule
    cell's float32 norm overflows to inf (in the reference too), where
    inf - inf would compare nothing; the float32 norms are recorded."""
    import dataclasses

    from repro_torch.common.tree import leaves, unflatten
    from repro_torch.models import dimenet
    from repro_torch.train.optimizer import global_norm
    from repro_torch.train.train_step import _accumulate_grads, dimenet_loss_fn

    def norm64(grads):
        return float(torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads)))

    cfg32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    gpu = dimenet.init(cfg32, seed=1, device="cuda")
    cpu = unflatten(gpu, [t.cpu() for t in leaves(gpu)])
    out, secs = {}, {}
    for name, params in (("cuda", gpu), ("cpu", cpu)):
        t0 = time.perf_counter()
        loss, grads, _ = _accumulate_grads(dimenet_loss_fn(cfg32), params, batch, 1)
        out[name] = (float(loss), [g.cpu() for g in grads], norm64(grads),
                     float(global_norm(grads)))
        secs[name] = time.perf_counter() - t0
    (lg, gg, ng, fg), (lc, gc_, nc, fc) = out["cuda"], out["cpu"]
    grad_err = max(float((g - c).abs().max()) / float(c.abs().max()) for g, c in zip(gg, gc_))
    record = {"dtype": "float32", "loss_cuda": lg, "loss_cpu": lc,
              "loss_rel_err": abs(lg - lc) / abs(lc), "grad_max_rel_err": grad_err,
              "grad_norm_cuda": ng, "grad_norm_cpu": nc, "grad_norm_rel_err": abs(ng - nc) / nc,
              "grad_norm_float32_cuda": fg, "grad_norm_float32_cpu": fc, "seconds": secs}
    record["within_limits"] = (record["loss_rel_err"] <= 1e-5 and grad_err <= 1e-3
                               and record["grad_norm_rel_err"] <= 1e-4)
    return record


def phase_gnn_training(steps: int = 5, cells=None) -> dict:
    """6e: DimeNet trained at full published width in three of the GNN
    cells (see the module docstring).  Returns each cell's step for the
    launch count taken after phase 7 (``phase_gnn_profile``)."""
    from repro_torch.configs import get_config, gnn_cell_config
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    ops.reset_launches()
    base = get_config("dimenet")
    makers = cells or {"molecule": gnn_molecule_cell, "full_graph_sm": gnn_full_graph_cell,
                       "minibatch_lg": gnn_minibatch_lane}
    out = {}
    for name, make in makers.items():
        t_cell = time.perf_counter()
        data = make()
        cfg = gnn_cell_config(base, name)
        cell = gnn_train_cell(cfg, data["batch"], steps)
        rec = {"phase": "gnn_training", "cell": name, "arch": "dimenet",
               "config": {"n_blocks": cfg.n_blocks, "d_hidden": cfg.d_hidden,
                          "n_bilinear": cfg.n_bilinear, "n_spherical": cfg.n_spherical,
                          "n_radial": cfg.n_radial, "d_node_feat": cfg.d_node_feat,
                          "param_dtype": cfg.param_dtype, "compute": "float32 (promoted)"},
               **data["info"], "host_s": data["host_s"], "timed_steps": steps,
               "optimizer": {"lr": 1e-3, "warmup_steps": 2, "total_steps": 20},
               **cell["record"]}
        if "host_s_by_stage" in data:
            rec["host_s_by_stage"] = data["host_s_by_stage"]
        rec["repeat_bits"] = gnn_repeat_bits(cell)
        rec["card_vs_cpu"] = gnn_card_vs_cpu(cfg, data["batch"])
        # held to the limits in (a) and (b); the lane's recorded: its loss is
        # one sum over 16,384 node outputs (3.6e-5 relative on an H100)
        if name != "minibatch_lg" and not rec["card_vs_cpu"]["within_limits"]:
            raise AssertionError(f"6e {name} card vs CPU: {rec['card_vs_cpu']}")
        rec["seconds"] = time.perf_counter() - t_cell
        emit(rec)
        out[name] = cell
        del data
        gc.collect()
    launched = dict(ops.KERNEL_LAUNCHES)
    if any(launched.values()):
        raise AssertionError(f"6e launched a kernel of the port's kernel layer: {launched}")
    emit({"phase": "gnn_training_summary", "cells": list(out), "kernel_layer_launches": launched,
          "seconds": time.perf_counter() - t_phase})
    return out


def phase_gnn_profile(cells: dict) -> dict:
    """6e's launch count, after phase 7: one step of each cell under
    ``torch.profiler`` (kernel launches, device busy and idle share, the
    top kernels).  The cells are freed."""
    out = {}
    for name in list(cells):
        cell = cells.pop(name)
        state = {"p": cell["params"], "s": cell["opt_state"]}

        def one_step():
            state["p"], state["s"], m = cell["step_fn"](state["p"], state["s"], cell["batch"])
            float(m["loss"])

        out[name] = device_profile(one_step)
        del cell, state
    emit({"phase": "gnn_profile", "steps_profiled": 1, **out})
    gc.collect()
    torch.cuda.empty_cache()
    return out

# ------------------------------------------------------------ 6f: cells and dry run

#: the background dry-run jobs of 6f, as one python program (run from the
#: repo root with ``src`` on the path; no CUDA): smollm-360m's train_4k cut
#: as 6f (b) runs it and one ogb_products lane on a fake world of one, and
#: the MoE / MLA train_4k cells at full depth on 16 x 16
DRYRUN_JOBS = """
import copy, dataclasses, json, sys, time
from repro_torch.configs.families import Cell, get_arch
from repro_torch.launch import dryrun as dr

out = []
arch = copy.copy(get_arch("smollm-360m"))
arch.num_micro = {num_micro}
cell = Cell("train_4k", "train", global_batch={global_batch}, seq_len={seq_len})
out.append(dr.run_cell("smollm-360m", "train_4k", mesh="1x1", arch=arch, cell=cell,
                       label="_cut"))
out.append(dr.run_cell("dimenet", "ogb_products", mesh="1x1"))
for aid in ("deepseek-moe-16b", "deepseek-v2-lite-16b"):
    out.append(dr.run_cell(aid, "train_4k"))
for r in out:
    r.pop("traceback", None)
json.dump(out, open(sys.argv[1], "w"))
"""


def start_dryrun_jobs(path: str, num_micro: int, global_batch: int, seq_len: int):
    """6f's dry runs in a background process on the host (they need no
    card): started before 6f so they overlap the card's phases."""
    code = DRYRUN_JOBS.format(num_micro=num_micro, global_batch=global_batch, seq_len=seq_len)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen([sys.executable, "-c", code, path], cwd=ROOT, env=env,
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)


def family_smokes() -> dict:
    """6f (a): every arch's ``smoke`` on the card: its metrics and seconds."""
    from repro_torch.configs.families import ARCH_IDS, get_arch

    out = {}
    for aid in ARCH_IDS:
        t0 = time.perf_counter()
        metrics = get_arch(aid).smoke(seed=0, device="cuda")
        out[aid] = {**metrics, "seconds": time.perf_counter() - t0}
    return out


def _full_np(t) -> np.ndarray:
    from torch.distributed.tensor import DTensor

    t = t.full_tensor() if isinstance(t, DTensor) else t
    return t.detach().to(torch.float32).cpu().numpy()


def _timed_steps(step_fn, state: dict, steps: int) -> dict:
    """One warm-up step, then ``steps`` timed (CUDA events): losses, step
    times, peak device bytes, K3 / K3-bwd launches of the timed steps."""
    from repro_torch.kernels import ops

    losses = []

    def one():
        state["p"], state["s"], m = step_fn(state["p"], state["s"], state["b"])
        losses.append(float(_full_np(m["loss"])))

    one()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    times = []
    for _ in range(steps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        one()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    launches = dict(ops.KERNEL_LAUNCHES)
    return {"losses": losses, "step_ms": times, "step_p50_ms": float(np.percentile(times, 50)),
            "peak_device_bytes": torch.cuda.max_memory_allocated(),
            "k3_launches": launches["flash_attention"],
            "k3_bwd_launches": launches["flash_attention_bwd"]}


def families_lm_cell(mesh, global_batch: int, seq_len: int, num_micro: int, steps: int) -> dict:
    """6f (b), on the world's one rank: smollm-360m's train_4k through
    ``LMArch.build_cell`` (full width and depth, the batch cut), params and
    moments DTensors with the cell's placements; then ``make_train_step``
    on plain tensors from the same seed and batch, its losses beside the
    cell's."""
    from repro_torch.configs.families import Cell, get_arch
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tf
    from repro_torch.train.optimizer import AdamWConfig, init_state
    from repro_torch.train.train_step import lm_loss_fn, make_train_step

    arch = copy.copy(get_arch("smollm-360m"))
    arch.num_micro = num_micro
    cell = Cell("train_4k", "train", global_batch=global_batch, seq_len=seq_len)
    spec = arch.build_cell(cell, mesh)
    t0 = time.perf_counter()
    params, st, batch = spec.make_args(seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    placements = {n: [str(p) for p in pl] for n, pl in spec.placements[0].items()
                  if n in ("embed", "blocks/0/attn/wq", "blocks/0/mlp/w_down")}
    cell_run = _timed_steps(spec.fn, {"p": params, "s": st, "b": batch}, steps)
    local_batch = {k: v.to_local() for k, v in batch.items()}
    del params, st, batch
    gc.collect()
    torch.cuda.empty_cache()
    cfg = arch._dryrun_model_cfg(cell)
    plain_params = tf.init(cfg, 0, "cuda")
    plain_step = make_train_step(lm_loss_fn(cfg), AdamWConfig(lr=3e-4, total_steps=10_000),
                                 num_micro=num_micro)
    ops.reset_launches()
    plain = _timed_steps(plain_step, {"p": plain_params, "s": init_state(plain_params),
                                      "b": local_batch}, steps)
    del plain_params, local_batch
    gc.collect()
    torch.cuda.empty_cache()
    a, b = np.array(cell_run["losses"]), np.array(plain["losses"])
    rel = float(np.max(np.abs(a - b) / np.abs(b)))
    return {"cell": cell_run, "plain": plain, "init_s": init_s, "placements": placements,
            "num_micro": num_micro, "layers": cfg.n_layers, "n_heads": cfg.n_heads,
            "head_dim": cfg.head_dim, "losses_bit_equal": bool(np.array_equal(a, b)),
            "losses_max_rel": rel}


def families_gnn_lane(mesh, steps: int) -> dict:
    """6f (c): one ogb_products lane at its full lane shape through
    ``GNNArch.build_cell`` on the world's one rank: a warm-up step, then
    ``steps`` timed; two steps run twice from one state (bit-equal); then
    one step's loss and grads in float32 on the lane cut to an eighth, on
    the card (the cell's DTensor path) and on the CPU (one device)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.common.tree import flatten, leaves, unflatten
    from repro_torch.configs.families import GNN_CELLS, get_arch, make_ctx
    from repro_torch.kernels import ops
    from repro_torch.models import dimenet as dn
    from repro_torch.train.train_step import _accumulate_grads, dimenet_loss_fn

    arch = get_arch("dimenet")
    cell = GNN_CELLS["ogb_products"]
    spec = arch.build_cell(cell, mesh)
    t0 = time.perf_counter()
    params, st, batch = spec.make_args(seed=0, device="cuda")
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    shapes = {k: list(v.shape) for k, v in batch.items()}
    real_triplets = int((batch["t_in"].to_local() >= 0).sum())
    state = {"p": params, "s": st, "b": batch}
    ops.reset_launches()
    run = _timed_steps(spec.fn, state, steps)
    if not all(np.isfinite(run["losses"])):
        raise AssertionError(f"6f (c) losses {run['losses']}")
    # two steps twice from one saved state
    tree = {"p": state["p"], "s": state["s"]}
    saved = [t.to_local().clone() if isinstance(t, DTensor) else t.clone()
             for t in leaves(tree)]

    def two_steps():
        for _ in range(2):
            state["p"], state["s"], _ = spec.fn(state["p"], state["s"], state["b"])
        return [t.to_local().clone() if isinstance(t, DTensor) else t.clone()
                for t in leaves({"p": state["p"], "s": state["s"]})]

    first = two_steps()
    with torch.no_grad():
        for t, s in zip(leaves({"p": state["p"], "s": state["s"]}), saved):
            (t.to_local() if isinstance(t, DTensor) else t).copy_(s)
    second = two_steps()
    bit_equal = all(torch.equal(x, y) for x, y in zip(first, second))
    kernel_layer = dict(ops.KERNEL_LAUNCHES)
    del state, params, st, batch, tree, saved, first, second
    gc.collect()
    torch.cuda.empty_cache()
    # card vs CPU, float32, the lane cut to an eighth
    n, E = cell.get("n_loc") // 8, cell.get("e_loc") // 8
    cut = dataclasses.replace(cell, extra=tuple(
        (k, n if k == "n_loc" else E if k == "e_loc" else v) for k, v in cell.extra))
    arch32 = copy.copy(arch)
    cfg32 = dataclasses.replace(arch._cfg_for_cell(cell), param_dtype="float32",
                                compute_dtype="float32")
    arch32._cfg_for_cell = lambda c: cfg32
    spec32 = arch32.build_cell(cut, mesh)
    p_card, _, b_card = spec32.make_args(seed=1, device="cuda")
    loss_c, g_c, _ = _accumulate_grads(dimenet_loss_fn(cfg32, make_ctx(mesh)), p_card, b_card, 1)
    p_cpu = dn.init(cfg32, 1, "cuda")
    p_cpu = unflatten(p_cpu, [t.cpu() for t in leaves(p_cpu)])
    b_cpu = {k: v.to_local().cpu() for k, v in b_card.items()}
    loss_p, g_p, _ = _accumulate_grads(dimenet_loss_fn(cfg32), p_cpu, b_cpu, 1)
    names = [nm for nm, _ in flatten(p_cpu)]
    grad_gap = max(float(np.abs(_full_np(a) - b.numpy()).max()) / max(float(b.abs().max()), 1e-30)
                   for a, b in zip(g_c, g_p))
    lc, lp = float(_full_np(loss_c)), float(loss_p)
    return {**run, "shapes": shapes, "real_triplets": real_triplets, "data_s": data_s,
            "repeat_bit_equal": bit_equal, "kernel_layer_launches": kernel_layer,
            "card_vs_cpu_f32": {"nodes": n, "edges": E, "loss_card": lc, "loss_cpu": lp,
                                "loss_rel": abs(lc - lp) / abs(lp),
                                "max_grad_gap_of_largest": grad_gap, "leaves": len(names)}}


def families_rank(mesh, global_batch: int, seq_len: int, num_micro: int, steps: int) -> dict:
    """The rank body of 6f (b) and (c) in one world of one rank (NCCL, mesh
    data 1 x model 1)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    lm = families_lm_cell(mesh, global_batch, seq_len, num_micro, steps)
    lm["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    gnn = families_gnn_lane(mesh, steps)
    gnn["seconds"] = time.perf_counter() - t0
    return {"lm": lm, "gnn": gnn}


def phase_families(dryrun, dryrun_path: str, global_batch: int = 16, seq_len: int = 4096,
                   num_micro: int = 4, steps: int = 3) -> dict:
    """6f: the sharded cells (``configs.families``) and the dry run
    (``launch.dryrun``); see the module docstring.  ``dryrun`` is the
    background process of :func:`start_dryrun_jobs`, joined here."""
    from repro_torch.launch.mesh import run_world

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    smokes = family_smokes()
    emit({"phase": "families_smoke", "archs": smokes, "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    world = run_world(families_rank, (1, 1), ("data", "model"),
                      (global_batch, seq_len, num_micro, steps), device="cuda", timeout=900)[0]
    world_s = time.perf_counter() - t0
    lm, gnn = world["lm"], world["gnn"]
    t0 = time.perf_counter()
    err = dryrun.communicate(timeout=600)[1]
    if dryrun.returncode != 0:
        raise AssertionError(f"6f dry runs failed: {err[-3000:]}")
    dry_wait_s = time.perf_counter() - t0
    dry = {f"{r['arch']}/{r['cell']}@{r['mesh']}": r for r in json.load(open(dryrun_path))}
    bad = {k: r.get("error") for k, r in dry.items() if r["status"] != "ok"}
    if bad:
        emit({"phase": "families", "world": world})
        raise AssertionError(f"6f dry runs in error: {bad}")
    L = lm["layers"]
    per_step = {"k3": lm["cell"]["k3_launches"] / steps,
                "k3_bwd": lm["cell"]["k3_bwd_launches"] / steps}
    lm_dry = dry["smollm-360m/train_4k_cut@1x1"]
    gnn_dry = dry["dimenet/ogb_products@1x1"]
    calib = {"smollm_train_4k_cut": {
                 "predicted_peak_bytes": lm_dry["memory"]["peak_bytes"],
                 "measured_peak_bytes": lm["cell"]["peak_device_bytes"],
                 "measured_over_predicted": lm["cell"]["peak_device_bytes"]
                 / lm_dry["memory"]["peak_bytes"]},
             "ogb_products_lane": {
                 "predicted_peak_bytes": gnn_dry["memory"]["peak_bytes"],
                 "measured_peak_bytes": gnn["peak_device_bytes"],
                 "measured_over_predicted": gnn["peak_device_bytes"]
                 / gnn_dry["memory"]["peak_bytes"]}}
    full_depth = {k: {"peak_bytes": r["memory"]["peak_bytes"],
                      "argument_bytes": r["memory"]["argument_bytes"],
                      "flops_per_rank": r["cost"]["flops"], "seconds": r["total_seconds"],
                      "fits": r["fits"], "collective_bytes": r["collectives"]["total_bytes"]}
                  for k, r in dry.items() if r["mesh"] == "16x16"}
    rec = {"phase": "families", "archs_smoked": len(smokes),
           "lm_cell": {"arch": "smollm-360m", "cell": "train_4k",
                       "reduced": {"global_batch": f"256 -> {global_batch}"},
                       "S": seq_len, "num_micro": num_micro, "mesh": "data 1 x model 1 (NCCL)",
                       **{k: v for k, v in lm.items() if k not in ("cell", "plain")},
                       "cell_run": lm["cell"], "plain_run": lm["plain"],
                       "k3_launches_per_step": per_step["k3"],
                       "k3_bwd_launches_per_step": per_step["k3_bwd"],
                       "losses_match": "bit-equal" if lm["losses_bit_equal"] else
                       f"within {lm['losses_max_rel']:.3g} relative"},
           "gnn_lane": {"arch": "dimenet", "cell": "ogb_products", "lanes": 1, **gnn},
           "dryrun_calibration": calib, "dryrun_full_depth_16x16": full_depth,
           "dryrun_records": {k: {"status": r["status"], "seconds": r["total_seconds"],
                                  "peak_bytes": r["memory"]["peak_bytes"]}
                              for k, r in dry.items()},
           "world_s": world_s, "dryrun_wait_s": dry_wait_s,
           "seconds": time.perf_counter() - t_phase}
    emit(rec)
    if per_step != {"k3": 2 * L * num_micro, "k3_bwd": L * num_micro}:
        raise AssertionError(f"6f (b) K3 / K3-bwd launches a step {per_step}, want "
                             f"{2 * L * num_micro} / {L * num_micro}")
    if not (lm["losses_bit_equal"] or lm["losses_max_rel"] <= 1e-6):
        raise AssertionError(f"6f (b) cell vs make_train_step losses: {lm['cell']['losses']} "
                             f"vs {lm['plain']['losses']}")
    if not all(np.isfinite(lm["cell"]["losses"])):
        raise AssertionError(f"6f (b) losses {lm['cell']['losses']}")
    if not gnn["repeat_bit_equal"]:
        raise AssertionError("6f (c): two steps from one state differ in their bits")
    if any(gnn["kernel_layer_launches"].values()):
        raise AssertionError(f"6f (c) launched a kernel: {gnn['kernel_layer_launches']}")
    return {"launches": lm["cell"]["k3_launches"] + lm["plain"]["k3_launches"],
            "bwd_launches": lm["cell"]["k3_bwd_launches"] + lm["plain"]["k3_bwd_launches"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    smi = timed("1", phase_card)
    max_err = timed("2", phase_kernel_vs_plain)
    max_err_q8 = timed("2b", phase_q8_kernel_vs_plain)
    max_err_k3 = timed("2c", phase_flash_vs_plain)
    k3_bwd = timed("2d", phase_flash_bwd_vs_plain)
    paper = timed("3", phase_paper)
    corpus, queries, gt_i, scan_ids = paper.pop("data")
    paper_q8 = timed("3b", phase_paper_q8, corpus, queries, gt_i, scan_ids)
    paper_hnsw = timed("3c", phase_paper_hnsw, corpus, queries, gt_i, scan_ids)
    hnsw_state = paper_hnsw.pop("state")
    hnsw_ids = paper_hnsw.pop("ids")
    paper_hnsw_q8 = timed("3d", phase_paper_hnsw_q8, hnsw_state, queries, gt_i, hnsw_ids,
                          len(corpus))
    persist = timed("3e", phase_persist_serve, paper.pop("index"), paper_hnsw.pop("index"),
                    paper_hnsw_q8.pop("index"), corpus, queries, gt_i, scan_ids, hnsw_ids,
                    paper_hnsw_q8.pop("ids"), paper_hnsw["build_s"])
    race = timed("3h a", phase_race_stress, persist.pop("scan_index"), queries)
    serve_step = timed("3f", phase_serve_step, corpus, queries, gt_i)
    profile_batch = queries[1024:2048]
    del corpus, queries, gt_i, scan_ids, hnsw_ids
    gc.collect()
    torch.cuda.empty_cache()
    deploy = timed("4", phase_deployment)
    deploy_q8 = timed("4b", phase_deployment_q8, *deploy.pop("data"))
    timed("3h c", phase_footprint_calibration,
          {phase: rec.pop("footprint") for phase, rec in (
              ("3", paper), ("3b", paper_q8), ("3c", paper_hnsw), ("3d", paper_hnsw_q8),
              ("4", deploy), ("4b", deploy_q8))})
    recsys = timed("3g", phase_recsys)
    # host work that needs no card runs beside the card's phases 5-6d: 6e's
    # Reddit-sized graph and sampled lane, 6f's dry runs and 3h (b)'s static
    # pass
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    (ROOT / "build").mkdir(exist_ok=True)
    dry_path = str(ROOT / "build" / f"dryrun_6f_{os.getpid()}.json")
    dryrun = start_dryrun_jobs(dry_path, num_micro=4, global_batch=16, seq_len=4096)
    static_pass = start_static_pass()
    lane_pool = ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"))
    try:
        lane = lane_pool.submit(gnn_minibatch_lane)
        prefill = timed("5", phase_prefill_32k)
        serve = timed("6", phase_serve_engine)
        train = timed("6b", phase_train_step)
        moe_mla = timed("6c", phase_moe_mla_serving)
        moe_train = timed("6d", phase_moe_mla_training)
        gnn = timed("6e", phase_gnn_training, 5, {"molecule": gnn_molecule_cell,
                                                 "full_graph_sm": gnn_full_graph_cell,
                                                 "minibatch_lg": lane.result})
        fam = timed("6f", phase_families, dryrun, dry_path)
        timed("3h b", finish_static_pass, static_pass)
    finally:
        lane_pool.shutdown(cancel_futures=True)
        if static_pass.poll() is None:
            static_pass.kill()
            static_pass.wait()
        if dryrun.poll() is None:
            dryrun.kill()
            dryrun.wait()
        if os.path.exists(dry_path):
            os.remove(dry_path)
    timed("7", phase_beam_profile, hnsw_state, profile_batch)
    del hnsw_state
    timed("6e profile", phase_gnn_profile, gnn)
    k1_scan_launches = (paper["launches"] + paper_hnsw["launches"] + persist["launches"]
                        + race["launches"] + serve_step["launches"] + deploy["launches"])
    k1_launches = k1_scan_launches + recsys["launches"]
    k2_launches = paper_q8["launches"] + deploy_q8["launches"]
    k3_launches = (prefill["launches"] + serve["launches"] + train["launches"]
                   + moe_mla["launches"] + moe_train["launches"] + fam["launches"])
    k3_bwd_launches = (train["bwd_launches"] + train["check_bwd"]["launches"]
                       + moe_train["bwd_launches"] + fam["bwd_launches"])
    if min(k1_launches, k2_launches, k3_launches, k3_bwd_launches) <= 0:
        raise AssertionError(f"a kernel of the main path was not launched: K1 {k1_launches}, "
                             f"K2 {k2_launches}, K3 {k3_launches}, K3-bwd {k3_bwd_launches}")
    # K1's and K2's launches by (B, N, D, k_pad), the same windows as the counts
    k1_by_shape = add_shapes(*(r["by_shape"] for r in (paper, paper_hnsw, persist, race,
                                                        serve_step, deploy, recsys)))
    k2_by_shape = add_shapes(paper_q8["by_shape"], deploy_q8["by_shape"])
    if (sum(k1_by_shape.values()), sum(k2_by_shape.values())) != (k1_launches, k2_launches):
        raise AssertionError(f"launches by shape {sum(k1_by_shape.values())} / "
                             f"{sum(k2_by_shape.values())} != {k1_launches} / {k2_launches}")
    t1, t2 = paper["timing"], paper_q8["timing"]
    k3_instances = [
        {key: rec[key] for key in ("dtype", "BH", "S", "D", "Dv", "causal", "launches",
                                   "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms", "library_backend")}
        for rec in (prefill["instances"] + serve["instances"] + train["instances"]
                    + moe_mla["instances"] + moe_train["instances"]
                    # 6f's cell runs 6b's layer shape (60, 4096, 64), timed there
                    + [{**train["instances"][0], "launches": fam["launches"]}])]
    t3 = k3_instances[0]  # the 32k prefill's bf16 shape
    t4 = k3_bwd["timing"]  # the training step's layer shape
    k1_keys = ("shape", "B", "N", "D", "k", "k_pad", "metric", "launches", "max_abs_err", "ms",
               "plain_ms", "bound_ms", "bound_by", "library_ms")
    # the scan phases' launches (3, 3c, 3e, 3f, 4) timed at the paper partition; 3g's at
    # the retrieval_cand cell's shape
    k1_instances = [{key: rec[key] for key in k1_keys}
                    for rec in ({**t1, "launches": k1_scan_launches},
                                {**recsys["timing"], "launches": recsys["launches"]})]
    # K2's: 3b's launches timed at the paper q8 partition, 4b's at the deployment one
    k2_keys = tuple(key for key in k1_keys if key != "metric")
    k2_instances = [{key: rec[key] for key in k2_keys}
                    for rec in ({**t2, "launches": paper_q8["launches"]},
                                {**deploy_q8["timing"], "launches": deploy_q8["launches"]})]
    bwd_keys = ("shape", "dtype", "BH", "S", "D", "Dv", "causal", "launches", "max_abs_err",
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library_backend")
    # 6b's timed steps (bf16, timed in 2d), then 6b's card-vs-CPU check
    # (float32); then per 6d arch its timed steps (bf16, timed in 2d) and
    # its card-vs-CPU check (float32)
    bwd_recs = [{**t4, "launches": train["bwd_launches"]}, train["check_bwd"]]
    for arch, b in moe_train["bwd"].items():
        bwd_recs += [{**k3_bwd["timings"][f"6d {arch}"], "launches": b["step"]}, b["check"]]
    bwd_recs.append({**t4, "launches": fam["bwd_launches"]})  # 6f's steps, 6b's shape
    k3_bwd_instances = [{key: rec[key] for key in bwd_keys} for rec in bwd_recs]
    emit({"phase": "total", "seconds": time.perf_counter() - t_start, "by_phase": seconds})
    emit({"launches_by_shape": {
        name: [[*map(int, key.split(",")), n]
               for key, n in sorted(counts.items(), key=lambda kv: -kv[1])]
        for name, counts in (("distance_topk", k1_by_shape), ("distance_topk_q8", k2_by_shape))},
        "key": ["B", "N", "D", "k_pad", "launches"]})
    emit({"kernels": [
        {"name": "distance_topk", "route": "cuda", "source": K1_SOURCE,
         "replaces": K1_REPLACES, "launches": k1_launches,
         "max_abs_err": max(max_err, t1["max_abs_err"], deploy["timing"]["max_abs_err"],
                            recsys["timing"]["max_abs_err"]),
         "ms": t1["ms"], "plain_ms": t1["plain_ms"], "bound_ms": t1["bound_ms"],
         "bound_by": t1["bound_by"], "library_ms": t1["library_ms"],
         "instances": k1_instances},
        {"name": "distance_topk_q8", "route": "cuda", "source": K2_SOURCE,
         "replaces": K2_REPLACES, "launches": k2_launches,
         "max_abs_err": max(max_err_q8, t2["max_abs_err"], deploy_q8["timing"]["max_abs_err"]),
         "ms": t2["ms"], "plain_ms": t2["plain_ms"], "bound_ms": t2["bound_ms"],
         "bound_by": t2["bound_by"], "library_ms": t2["library_ms"],
         "instances": k2_instances},
        {"name": "flash_attention", "route": "cuda", "source": K3_SOURCE,
         "replaces": K3_REPLACES, "launches": k3_launches,
         "max_abs_err": max(max_err_k3["f32"], max_err_k3["bf16"], prefill["max_abs_err"],
                            moe_mla["max_abs_err"], *(i["max_abs_err"] for i in k3_instances)),
         "ms": t3["ms"], "plain_ms": t3["plain_ms"], "bound_ms": t3["bound_ms"],
         "bound_by": t3["bound_by"], "library_ms": t3["library_ms"],
         "instances": k3_instances},
        {"name": "flash_attention_bwd", "route": "cuda", "source": K3_BWD_SOURCE,
         "replaces": K3_BWD_REPLACES, "launches": k3_bwd_launches,
         "max_abs_err": max(k3_bwd["max_abs_err"], train["check_bwd"]["max_abs_err"],
                            moe_train["bwd_max_abs_err"]),
         "ms": t4["ms"], "plain_ms": t4["plain_ms"], "bound_ms": t4["bound_ms"],
         "bound_by": t4["bound_by"], "library_ms": t4["library_ms"],
         "instances": k3_bwd_instances},
    ], "not_launched_by": {"3c/3d HNSW beam": "torch ops",
                           "6e / 6f DimeNet training": "torch ops"}})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
