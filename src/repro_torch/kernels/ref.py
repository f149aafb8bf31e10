"""Plain PyTorch versions of the kernels in this package.

They are what the kernel wrappers run on CPU tensors, and the versions the
kernels are held against on the card.  On CUDA tensors they run with TF32
off, so a float32 product keeps full float32 precision.
"""

from __future__ import annotations

import torch


def _no_tf32(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False


def distance_matrix(q: torch.Tensor, x: torch.Tensor, metric: str) -> torch.Tensor:
    """(B, d) x (N, d) -> (B, N) distances, lower is better.

    l2:  true squared euclidean distance.
    ip:  negative inner product.
    cos: negative cosine similarity (inputs need not be normalized).
    """
    _no_tf32(q)
    if metric == "l2":
        qn = (q * q).sum(-1, keepdim=True)
        xn = (x * x).sum(-1)
        return qn - 2.0 * (q @ x.T) + xn[None, :]
    if metric == "ip":
        return -(q @ x.T)
    if metric == "cos":
        qn = q / q.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        xn = x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        return -(qn @ xn.T)
    raise ValueError(metric)


def distance_topk_ref(q: torch.Tensor, x: torch.Tensor, k: int, metric: str = "l2"):
    """Full (B, N) distance matrix + top-k.  Returns (dists (B, k)
    ascending, ids (B, k) int32)."""
    d = distance_matrix(q, x, metric)
    vals, idx = torch.topk(d, k, dim=1, largest=False, sorted=True)
    return vals, idx.to(torch.int32)


def distance_topk_blocked(
    q: torch.Tensor,
    x: torch.Tensor,
    k: int,
    metric: str = "l2",
    block_n: int = 4096,
    n_valid: int | None = None,
):
    """Scan over N blocks carrying a running top-k; rows >= ``n_valid`` are
    padding and never win.

    Same result as ``distance_topk_ref`` without the full (B, N) matrix.
    Blocks wholly past ``n_valid`` are not scored at all (they could only
    contribute (inf, -1)).  Returns (dists (B, k) ascending, ids (B, k)
    int32), (inf, -1) where fewer than k valid rows exist.
    """
    B = q.shape[0]
    N = x.shape[0]
    nv = N if n_valid is None else min(int(n_valid), N)
    run_d = torch.full((B, k), float("inf"), dtype=torch.float32, device=q.device)
    run_i = torch.full((B, k), -1, dtype=torch.int32, device=q.device)
    for start in range(0, nv, block_n):
        xb = x[start: start + block_n]
        d = distance_matrix(q, xb, metric).to(torch.float32)
        gid = torch.arange(
            start, start + xb.shape[0], dtype=torch.int32, device=q.device
        )
        d = torch.where((gid < nv)[None, :], d, float("inf"))
        cat_d = torch.cat([run_d, d], dim=1)
        cat_i = torch.cat([run_i, gid[None, :].expand(B, -1)], dim=1)
        run_d, idx = torch.topk(cat_d, k, dim=1, largest=False, sorted=True)
        run_i = torch.gather(cat_i, 1, idx)
    run_i = torch.where(torch.isinf(run_d), -1, run_i)
    return run_d, run_i


def q8_score_matrix(
    q_codes: torch.Tensor,  # (B, D) int8
    x_codes: torch.Tensor,  # (N, D) int8
    q_scale: torch.Tensor,  # (B,) float32
    norms2: torch.Tensor,  # (N,) float32
    metric: str,
) -> torch.Tensor:
    """(B, N) stage-1 quantized scores, lower is better: the plain version
    of K2's per-tile arithmetic.

    The dot is exact on every device: CUDA has no general int32 matmul, so
    it runs as a float64 matmul of the codes (|dot| <= 2048 * 127^2 < 2^53,
    so every partial sum is an exact integer) and is converted to float32
    once — the same value as the reference's int32 -> float32 rounding.
    Then ONE float32 rescale, and the metric term, in the reference's order.
    """
    dots = (q_codes.to(torch.float64) @ x_codes.to(torch.float64).T).to(torch.float32)
    qx = dots * q_scale[:, None]
    if metric == "l2":
        return norms2[None, :] - 2.0 * qx
    if metric == "ip":
        return -qx
    raise ValueError(metric)


def distance_topk_q8_blocked(
    q_codes: torch.Tensor,
    x_codes: torch.Tensor,
    q_scale: torch.Tensor,
    norms2: torch.Tensor,
    k: int,
    metric: str = "l2",
    block_n: int = 4096,
    n_valid: int | None = None,
):
    """Int8 scan over N blocks carrying a running top-k; rows >= ``n_valid``
    are padding and never win.

    Scores are bit-equal to K2's; ties at the k boundary may be broken
    differently.  Returns (dists (B, k) ascending, ids (B, k) int32), with
    (inf, -1) where fewer than k valid rows exist.
    """
    B = q_codes.shape[0]
    N = x_codes.shape[0]
    nv = N if n_valid is None else min(int(n_valid), N)
    dev = q_codes.device
    run_d = torch.full((B, k), float("inf"), dtype=torch.float32, device=dev)
    run_i = torch.full((B, k), -1, dtype=torch.int32, device=dev)
    for start in range(0, nv, block_n):
        stop = min(start + block_n, nv)
        d = q8_score_matrix(q_codes, x_codes[start:stop], q_scale, norms2[start:stop], metric)
        gid = torch.arange(start, stop, dtype=torch.int32, device=dev)
        cat_d = torch.cat([run_d, d], dim=1)
        cat_i = torch.cat([run_i, gid[None, :].expand(B, -1)], dim=1)
        run_d, idx = torch.topk(cat_d, k, dim=1, largest=False, sorted=True)
        run_i = torch.gather(cat_i, 1, idx)
    run_i = torch.where(torch.isinf(run_d), -1, run_i)
    return run_d, run_i
