"""Serving entry point: build (or resume) a LANNS index and serve queries.

The port of ``repro.launch.serve``::

    python -m repro_torch.launch.serve --corpus-size 20000 --dim 64 --mode offline
    python -m repro_torch.launch.serve --index-dir build/idx --mode online

``--mode offline`` runs the paper's offline pipeline (build -> query ->
recall report); ``--mode online`` serves batches of 32 after
``warm_traces`` and reports QPS and batch-latency percentiles.
``--index-dir`` checkpoints the build there: a second run loads the
partitions already saved instead of rebuilding them.  ``--device``
defaults to ``cuda``; ``--device cpu`` runs the plain PyTorch path.
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--corpus-size", type=int, default=20_000)
    p.add_argument("--dim", type=int, default=64)
    p.add_argument("--queries", type=int, default=500)
    p.add_argument("--topk", type=int, default=100)
    p.add_argument("--shards", type=int, default=2)
    p.add_argument("--segments", type=int, default=4)
    p.add_argument("--segmenter", default="apd", choices=["rs", "rh", "apd"])
    p.add_argument("--engine", default="scan", choices=["scan", "hnsw"])
    p.add_argument("--alpha", type=float, default=0.15)
    p.add_argument("--mode", default="offline", choices=["offline", "online"])
    p.add_argument("--index-dir", default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    import torch

    from repro_torch.core import LannsConfig, LannsIndex, brute_force_topk, recall_table
    from repro_torch.data.synthetic import clustered_vectors

    corpus = clustered_vectors(
        args.corpus_size, args.dim, n_clusters=max(64, args.corpus_size // 500), seed=args.seed,
    )
    queries = clustered_vectors(
        args.queries, args.dim, n_clusters=max(64, args.corpus_size // 500), seed=args.seed + 1,
    )
    cfg = LannsConfig(
        num_shards=args.shards, num_segments=args.segments, segmenter=args.segmenter,
        alpha=args.alpha, engine=args.engine,
    )
    idx = LannsIndex(cfg, device=args.device)
    print(f"building LANNS ({args.shards},{args.segments})-{args.segmenter} "
          f"over {args.corpus_size} x {args.dim} on {idx.device} ...")
    t0 = time.time()
    idx.build(corpus, resume_dir=args.index_dir)
    built = len(idx.build_stats["per_partition_seconds"])
    print(f"build: {time.time() - t0:.1f}s  partitions built {built} of {len(idx.partitions)}  "
          f"stats={ {k: v for k, v in idx.build_stats.items() if 'seconds' in k} }")
    if args.index_dir:
        idx.save(args.index_dir)

    sync = torch.cuda.synchronize if idx.device.type == "cuda" else (lambda: None)
    if args.mode == "offline":
        t0 = time.time()
        d, i, stats = idx.query(queries, args.topk, return_stats=True)
        tq = time.time() - t0
        td, ti = brute_force_topk(queries, corpus, args.topk, device=idx.device)
        print(f"query: {1e3 * tq / len(queries):.2f} ms/query  {stats}")
        print("recall:", {k: round(v, 4) for k, v in recall_table(i, ti).items()})
    else:
        idx.warm_traces(32, args.topk)
        lat = []
        for s in range(0, len(queries), 32):
            t0 = time.perf_counter()
            idx.query(queries[s: s + 32], args.topk)
            sync()
            lat.append(time.perf_counter() - t0)
        lat = np.array(lat)
        print(
            f"online: {32 * len(lat) / lat.sum():.0f} QPS  "
            f"p50 {1e3 * np.percentile(lat, 50):.1f} ms/batch  "
            f"p99 {1e3 * np.percentile(lat, 99):.1f} ms/batch"
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
