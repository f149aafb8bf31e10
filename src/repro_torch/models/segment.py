"""Fixed-order gather and segment sum.

The reference's embedding lookups, gathers and ``jax.ops.segment_sum`` are
scatter-adds in their backward (or forward).  On the card ``index_add_``
and ``index_put_(accumulate=True)`` are atomic, in an order that changes
from run to run, so a step's grads would differ in their last bits.  Here
each index array gets a :class:`FixedIndex`: a stable argsort and the CSR
offsets of each destination row.  :func:`gather` and :func:`segment_sum`
are each other's gradient, and the sum is a ``torch.segment_reduce`` over
the rows sorted by destination, which adds a segment's rows one after
another.  The stable sort keeps the index order inside each destination,
the order of the reference's scatter-add on the CPU, so the sums round as
the reference's do and are the same bits every run.
"""

from __future__ import annotations

from functools import cached_property

import torch


class FixedIndex:
    """An index array ``idx`` (M,) into ``n`` rows, with the order that sums
    over it, built on idx's device with no host sync when first needed
    (a gather's forward needs neither): ``order``, a stable argsort of
    ``idx``, and ``offsets`` (n + 1,), where row r's entries start in
    ``order``."""

    def __init__(self, idx: torch.Tensor, n: int):
        self.idx = idx.long()
        self.n = n

    @cached_property
    def order(self) -> torch.Tensor:
        return torch.argsort(self.idx, stable=True)

    @cached_property
    def offsets(self) -> torch.Tensor:
        rows = torch.arange(self.n + 1, device=self.idx.device)
        return torch.searchsorted(self.idx[self.order], rows)


def _sum_rows(x: torch.Tensor, fi: FixedIndex) -> torch.Tensor:
    """(n, ...) sums of x's rows by destination ``fi.idx``, each in index
    order; an empty row sums to zeros."""
    return torch.segment_reduce(x.index_select(0, fi.order), "sum", offsets=fi.offsets, axis=0,
                                unsafe=True)


class _Gather(torch.autograd.Function):
    """y = x[idx]; its gradient sums each row's grads in index order."""

    @staticmethod
    def forward(ctx, x, fi: FixedIndex):
        ctx.fi = fi
        return x.index_select(0, fi.idx)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        return _sum_rows(g, ctx.fi), None


class _SegmentSum(torch.autograd.Function):
    """y[r] = the sum of x's rows with idx == r, in index order; its
    gradient is the gather g[idx]."""

    @staticmethod
    def forward(ctx, x, fi: FixedIndex):
        ctx.fi = fi
        return _sum_rows(x, fi)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        return g.index_select(0, ctx.fi.idx), None


def gather(x: torch.Tensor, fi: FixedIndex) -> torch.Tensor:
    """``x[fi.idx]``, whose backward is a fixed-order segment sum (not an
    atomic scatter-add).  Where no gradient flows (serving), a plain
    ``index_select``: the autograd function's host cost shows in a
    launch-bound forward."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Gather.apply(x, fi)
    return x.index_select(0, fi.idx)


def segment_sum(x: torch.Tensor, fi: FixedIndex) -> torch.Tensor:
    """``jax.ops.segment_sum(x, fi.idx, num_segments=fi.n)`` in a fixed
    order; its backward is a gather."""
    return _SegmentSum.apply(x, fi)


def sharded_lookup(table, ids):
    """``table[ids]`` (ids >= 0; rows, then the ids' shape) for a DTensor
    ``table`` sharded by row over some mesh axes (or replicated) and
    DTensor ``ids`` sharded over others, through ``local_map``: each rank
    masks the ids outside its rows, looks the rest up in its shard with the
    fixed-order :func:`gather` and sums the shards' rows over the table's
    axes (``sharding_rules.psum``).  The result is sharded as the ids are.
    The table's gradient is its rows' share on each rank (a partial sum
    over the ids' axes).  A table sharded over no mesh dim of more than
    one rank is looked up whole (``table[ids]``, as on one device)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.distributed.sharding_rules import psum, shard_start

    mesh = table.device_mesh
    names = tuple(mesh.mesh_dim_names)
    t_axes = [a for a, p in zip(names, table.placements)
              if isinstance(p, Shard) and mesh.size(names.index(a)) > 1]
    if any(p != Shard(0) for p in table.placements if isinstance(p, Shard)):
        raise ValueError(f"sharded_lookup: table placements {table.placements}; rows only")
    ids_pl = [p if isinstance(p, Shard) and a not in t_axes else Replicate()
              for a, p in zip(names, ids.placements)]
    id_axes = [a for a, p in zip(names, ids_pl) if isinstance(p, Shard)]
    t_pl = [Shard(0) if a in t_axes else Replicate() for a in names]
    t_grad = [Shard(0) if a in t_axes else Partial() if a in id_axes else Replicate()
              for a in names]
    n_rows = table.shape[0]

    def local(t_loc, ids_loc):
        if not t_axes:  # the rows whole on this rank: one device's lookup
            return t_loc[ids_loc.long()]
        rel = ids_loc.reshape(-1).long() - shard_start(mesh, t_axes, n_rows)
        mine = (rel >= 0) & (rel < t_loc.shape[0])
        rows = gather(t_loc, FixedIndex(torch.where(mine, rel, 0), t_loc.shape[0]))
        rows = torch.where(mine[:, None], rows, 0.0).to(t_loc.dtype)
        out = psum(rows, mesh, t_axes)
        return out.reshape(*ids_loc.shape, t_loc.shape[1])

    fn = local_map(local, out_placements=ids_pl, in_placements=(t_pl, ids_pl),
                   in_grad_placements=(t_grad, ids_pl), device_mesh=mesh,
                   redistribute_inputs=True)
    return fn(table, ids)
