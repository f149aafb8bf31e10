"""Public wrapper around the kernels: the one entry point the rest of the
package uses.

``distance_topk`` keeps the wrapper contract of ``repro.kernels.ops``:
empty corpora and ``k > N`` pad with (inf, -1), ``cos`` normalizes once and
scores as ``ip``, ``l2`` adds ``||q||^2`` back, inf maps to id -1.  Which
code runs follows the tensors: on CPU tensors the plain PyTorch version
(``ref.distance_topk_blocked``), on CUDA tensors the K1 kernel — never a
fallback from one to the other.
"""

from __future__ import annotations

import torch

from repro_torch.common.utils import next_pow2
from repro_torch.kernels import ref
from repro_torch.kernels.distance_topk import distance_topk_cuda

LANE = 128

#: kernel launches by the wrappers of this module, by kernel name
KERNEL_LAUNCHES = {"distance_topk": 0}


def reset_launches() -> None:
    for name in KERNEL_LAUNCHES:
        KERNEL_LAUNCHES[name] = 0


def distance_topk(q, x, k: int, metric: str = "l2", *, n_valid: int | None = None):
    """Top-k nearest rows of ``x`` for each row of ``q``.

    Returns (dists (B, k) ascending float32, ids (B, k) int32; id -1 where
    fewer than k valid rows exist).  For metric='l2' distances are true
    squared L2; for 'ip'/'cos' they are negative (inner product / cosine
    similarity).  ``n_valid``: rows >= n_valid of ``x`` are padding.
    """
    if metric not in ("l2", "ip", "cos"):
        raise ValueError(metric)
    q = torch.as_tensor(q)
    x = torch.as_tensor(x)
    if q.device != x.device:
        raise ValueError(f"q on {q.device} but x on {x.device}")
    dev = q.device
    B = q.shape[0]
    N = x.shape[0]
    nv = N if n_valid is None else min(int(n_valid), N)
    if N == 0 or nv == 0:
        return (
            torch.full((B, k), float("inf"), dtype=torch.float32, device=dev),
            torch.full((B, k), -1, dtype=torch.int32, device=dev),
        )
    if k > N:  # fewer corpus rows than requested: pad with (inf, -1)
        d, i = distance_topk(q, x, N, metric, n_valid=nv)
        pad_d = torch.full((B, k - N), float("inf"), dtype=d.dtype, device=dev)
        pad_i = torch.full((B, k - N), -1, dtype=i.dtype, device=dev)
        return torch.cat([d, pad_d], 1), torch.cat([i, pad_i], 1)
    q = q.to(torch.float32)
    x = x.to(torch.float32)
    if metric == "cos":
        q = q / q.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        x = x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        metric_k = "ip"
    else:
        metric_k = metric

    if dev.type == "cpu":
        return ref.distance_topk_blocked(q, x, k, metric_k, n_valid=nv)
    if dev.type != "cuda":
        raise ValueError(f"distance_topk: unsupported device {dev}")
    k_pad = max(next_pow2(k), LANE)
    if k_pad > 256:
        raise NotImplementedError(
            f"distance_topk: k={k} needs k_pad={k_pad} > 256 on CUDA "
            "(ROADMAP: K1 for k_pad > 256)"
        )
    if B == 0:
        return (
            torch.empty((0, k), dtype=torch.float32, device=dev),
            torch.empty((0, k), dtype=torch.int32, device=dev),
        )
    out_d, out_i = distance_topk_cuda(
        q.contiguous(), x.contiguous(), k_pad=k_pad, n_valid=nv, metric=metric_k
    )
    KERNEL_LAUNCHES["distance_topk"] += 1
    out_d, out_i = out_d[:, :k], out_i[:, :k]
    if metric == "l2":
        qn = (q * q).sum(-1, keepdim=True)
        out_d = torch.where(torch.isinf(out_d), out_d, out_d + qn)
    out_i = torch.where(torch.isinf(out_d), -1, out_i)
    return out_d, out_i
