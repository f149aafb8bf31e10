"""Two-level merging + perShardTopK (paper §5.3).

``per_shard_topk`` implements Eq. (5)-(6) in pure Python, as
``repro.core.merge`` does.  The merges run as tensor ops on the device that
holds the candidates; ``merge_topk_np`` is the loop reference.  All merges
take (..., C) candidate lists with LOWER-IS-BETTER distances, invalid
entries being (+inf, -1).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _probit(q: float) -> float:
    """Φ^{-1}(q) — Acklam's rational approximation (|err| < 1.15e-9)."""
    if not 0.0 < q < 1.0:
        raise ValueError(q)
    a = [-3.969683028665376e01, 2.209460984245205e02, -2.759285104469687e02,
         1.383577518672690e02, -3.066479806614716e01, 2.506628277459239e00]
    b = [-5.447609879822406e01, 1.615858368580409e02, -1.556989798598866e02,
         6.680131188771972e01, -1.328068155288572e01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e00,
         -2.549732539343734e00, 4.374664141464968e00, 2.938163982698783e00]
    d = [7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e00,
         3.754408661907416e00]
    plow, phigh = 0.02425, 1 - 0.02425
    if q < plow:
        u = math.sqrt(-2 * math.log(q))
        return (((((c[0] * u + c[1]) * u + c[2]) * u + c[3]) * u + c[4]) * u + c[5]) / (
            (((d[0] * u + d[1]) * u + d[2]) * u + d[3]) * u + 1
        )
    if q > phigh:
        u = math.sqrt(-2 * math.log(1 - q))
        return -(((((c[0] * u + c[1]) * u + c[2]) * u + c[3]) * u + c[4]) * u + c[5]) / (
            (((d[0] * u + d[1]) * u + d[2]) * u + d[3]) * u + 1
        )
    u = q - 0.5
    t = u * u
    return (
        (((((a[0] * t + a[1]) * t + a[2]) * t + a[3]) * t + a[4]) * t + a[5])
        * u
        / (((((b[0] * t + b[1]) * t + b[2]) * t + b[3]) * t + b[4]) * t + 1)
    )


def per_shard_topk(topk: int, num_shards: int, confidence: float = 0.95) -> int:
    """Eq. (5)-(6).  perShardTopK = min(topK, ceil(cI * topK)), with
    f(p) = Φ^{-1}((1+p)/2) (p=0.95 → 1.96); S=1 gives topK."""
    if num_shards <= 1:
        return topk
    s_prime = 1.0 / num_shards
    f = _probit((1.0 + confidence) / 2.0)
    ci = s_prime + f * math.sqrt(s_prime * (1.0 - s_prime) / topk)
    return min(topk, int(math.ceil(ci * topk)))


def _pad_k(out_d: torch.Tensor, out_i: torch.Tensor, k: int):
    kk = out_d.shape[-1]
    if kk >= k:
        return out_d, out_i
    lead = out_d.shape[:-1]
    pad_d = torch.full((*lead, k - kk), float("inf"), dtype=out_d.dtype, device=out_d.device)
    pad_i = torch.full((*lead, k - kk), -1, dtype=out_i.dtype, device=out_i.device)
    return torch.cat([out_d, pad_d], -1), torch.cat([out_i, pad_i], -1)


def _stable_order(keys: torch.Tensor, order=None) -> torch.Tensor:
    """Row-wise stable argsort of ``keys`` (taken through ``order`` when
    given), composed onto ``order`` — one pass of a lexsort."""
    if order is not None:
        keys = torch.gather(keys, -1, order)
    idx = torch.sort(keys, dim=-1, stable=True).indices
    return idx if order is None else torch.gather(order, -1, idx)


def merge_topk_vec(dists: torch.Tensor, ids: torch.Tensor, k: int):
    """Dedup merge: semantics of ``merge_topk_np``, as tensor ops.

    Entries with id < 0 or an infinite distance are dropped; duplicate ids
    keep their minimum distance; output is ascending by (distance, id) and
    padded with (+inf, -1).  Two stable sorts group by id with distance as
    the tie-break (so each id-run's head carries the run minimum), the rest
    of each run is masked, and two more order the survivors by (distance,
    id).
    """
    C = dists.shape[-1]
    sentinel = (
        torch.iinfo(ids.dtype).max if not ids.dtype.is_floating_point else float("inf")
    )
    invalid = (ids < 0) | torch.isinf(dists)
    dk = torch.where(invalid, float("inf"), dists)
    ik = torch.where(invalid, torch.full_like(ids, sentinel), ids)
    order = _stable_order(ik, _stable_order(dk))  # by id, then distance
    sid = torch.gather(ik, -1, order)
    sd = torch.gather(dk, -1, order)
    sinv = torch.gather(invalid, -1, order)
    dup = torch.zeros_like(sinv)
    dup[..., 1:] = sid[..., 1:] == sid[..., :-1]
    sd = torch.where(dup | sinv, float("inf"), sd)
    kk = min(k, C)
    order = _stable_order(sd, _stable_order(sid))[..., :kk]  # by distance, then id
    out_d = torch.gather(sd, -1, order)
    out_i = torch.where(torch.isinf(out_d), -1, torch.gather(sid, -1, order))
    return _pad_k(out_d, out_i.to(ids.dtype), k)


def merge_topk_disjoint(dists: torch.Tensor, ids: torch.Tensor, k: int):
    """Dedup-FREE top-k merge: valid only when candidate ids are disjoint
    across the merged lists (virtual spill: every point lives in one
    (shard, segment)).  Ascending by distance, (+inf, -1) padding; tie
    order among equal distances is unspecified."""
    C = dists.shape[-1]
    kk = min(k, C)
    out_d, sel = torch.topk(dists, kk, dim=-1, largest=False, sorted=True)
    out_i = torch.where(torch.isinf(out_d), -1, torch.gather(ids, -1, sel))
    return _pad_k(out_d, out_i, k)


def merge_topk_np(dists: np.ndarray, ids: np.ndarray, k: int):
    """Python-loop reference of the merges (ground truth for parity tests)."""
    *lead, C = dists.shape
    dists2 = dists.reshape(-1, C)
    ids2 = ids.reshape(-1, C)
    out_d = np.full((dists2.shape[0], k), np.inf, dtype=dists.dtype)
    out_i = np.full((dists2.shape[0], k), -1, dtype=ids.dtype)
    for r in range(dists2.shape[0]):
        seen: dict[int, float] = {}
        for d, i in zip(dists2[r], ids2[r]):
            if i < 0 or np.isinf(d):
                continue
            if i not in seen or d < seen[i]:
                seen[int(i)] = float(d)
        pairs = sorted((d, i) for i, d in seen.items())[:k]
        for c, (d, i) in enumerate(pairs):
            out_d[r, c] = d
            out_i[r, c] = i
    return out_d.reshape(*lead, k), out_i.reshape(*lead, k)
