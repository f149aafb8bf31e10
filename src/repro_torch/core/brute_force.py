"""Exact brute-force top-k (paper §5.4) — the ground truth recall is held to.

The corpus is uploaded once; each (partition, query block) is scored by the
same fused distance + top-k kernel as serving, and the partial results merge
by query.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.common.utils import resolve_device
from repro_torch.core.merge import merge_topk_vec
from repro_torch.kernels import ops


def brute_force_topk(
    queries,
    corpus,
    k: int,
    metric: str = "l2",
    *,
    num_partitions: int = 1,
    query_block: int = 4096,
    device=None,
):
    """Exact top-k via partitioned scan + merge.

    queries (B, d), corpus (N, d) -> (dists (B, k) float32, ids (B, k)
    int64) as numpy arrays; ids index ``corpus`` rows.  Runs on the CUDA
    device unless ``device`` names another.
    """
    dev = resolve_device(device)
    q = torch.as_tensor(np.asarray(queries, dtype=np.float32)).to(dev)
    x = torch.as_tensor(corpus).to(device=dev, dtype=torch.float32)
    B = q.shape[0]
    N = x.shape[0]
    bounds = np.linspace(0, N, num_partitions + 1).astype(np.int64)
    part_d = torch.full((B, num_partitions, k), float("inf"), device=dev)
    part_i = torch.full((B, num_partitions, k), -1, dtype=torch.int64, device=dev)
    for p in range(num_partitions):
        lo, hi = int(bounds[p]), int(bounds[p + 1])
        if hi <= lo:
            continue
        kk = min(k, hi - lo)
        for qs in range(0, B, query_block):
            qe = min(qs + query_block, B)
            d, i = ops.distance_topk(q[qs:qe], x[lo:hi], kk, metric)
            i = i.to(torch.int64)
            part_d[qs:qe, p, :kk] = d
            part_i[qs:qe, p, :kk] = torch.where(i >= 0, i + lo, -1)
    out_d, out_i = merge_topk_vec(part_d.reshape(B, -1), part_i.reshape(B, -1), k)
    return out_d.cpu().numpy(), out_i.cpu().numpy()
