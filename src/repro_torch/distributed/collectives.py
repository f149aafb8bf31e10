"""Collective schedules over the process groups of a named mesh.

The port of ``repro.distributed.collectives``: ``ring_topk_merge`` (the
hypercube top-k merge) and the all-gather that is the LANNS broker.  A
``jax.lax`` collective over a mesh axis becomes a ``torch.distributed``
call inside that axis's group (``mesh.get_group(axis)``).

Gloo moves host tensors: a world on gloo whose tensors live on a card
(two ranks on one GPU, ``launch/mesh.py``) copies each payload to the
host, runs the collective there and copies the result back.  That is the
gloo path of each collective, chosen from the group's backend; NCCL moves
card tensors directly.

``hierarchical_grad_sync`` is a training path and ports with the training
slice (ROADMAP).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.merge import _stable_order


def _wire(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` as the group's backend moves it: on the host for gloo."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        return t.cpu()
    return t.contiguous()


def all_gather_stacked(t: torch.Tensor, group) -> torch.Tensor:
    """(n, *t.shape): every rank's ``t`` in group-rank order — the
    ``jax.lax.all_gather(t, axis)`` of one mesh axis."""
    n = dist.get_world_size(group)
    src = _wire(t, group)
    out = torch.empty((n * src.shape[0], *src.shape[1:]), dtype=src.dtype, device=src.device)
    dist.all_gather_into_tensor(out, src, group=group)
    return out.to(t.device).view(n, *t.shape)


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``t`` over the group (``jax.lax.psum`` over one axis)."""
    src = _wire(t, group).clone()
    dist.all_reduce(src, op=dist.ReduceOp.SUM, group=group)
    return src.to(t.device)


def _exchange(tensors, partner: int, group):
    """Send ``tensors`` to group rank ``partner`` and receive its own —
    one pairwise ``jax.lax.ppermute`` step."""
    peer = dist.get_global_rank(group, partner)
    send = [_wire(t, group) for t in tensors]
    recv = [torch.empty_like(s) for s in send]
    ops = [dist.P2POp(dist.isend, s, peer, group) for s in send]
    ops += [dist.P2POp(dist.irecv, r, peer, group) for r in recv]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [r.to(t.device) for r, t in zip(recv, tensors)]


def ring_topk_merge(dists: torch.Tensor, ids: torch.Tensor, k: int, group):
    """Log-depth alternative to all_gather + merge for the LANNS shard
    merge: pairwise exchanges over a hypercube in log2(S) rounds, the
    candidates kept at k (not S*k) after each.

    dists / ids: (B, k0) local candidates, lower is better; returns the
    merged (B, k) on every rank of ``group``, whose size must be a power
    of two.  Each round keeps the k smallest of [own, partner's] with ties
    to the earlier entry, as ``jax.lax.top_k`` does.
    """
    size = dist.get_world_size(group)
    if size & (size - 1):
        raise ValueError(f"ring_topk_merge needs a power-of-two group, got {size}")
    me = dist.get_rank(group)
    d, i = dists, ids
    for r in range(size.bit_length() - 1):
        od, oi = _exchange((d, i), me ^ (1 << r), group)
        cd = torch.cat([d, od], dim=-1)
        ci = torch.cat([i, oi], dim=-1)
        sel = _stable_order(cd)[..., :k]
        d, i = torch.gather(cd, -1, sel), torch.gather(ci, -1, sel)
    return d, i
