"""Sharding rules: logical-axis annotations decoupled from the mesh.

The port of ``repro.distributed.sharding_rules``.  Models never import a
mesh.  They call ``ctx.constrain(x, *logical_axes)`` with *logical* names;
:class:`ShardingCtx` maps logical -> mesh axes.  The mesh is
``launch/mesh.py``'s named ``DeviceMesh``; a spec (one entry a tensor dim:
``None``, a mesh axis, or a tuple of axes) becomes DTensor placements
(``Shard(dim)`` / ``Replicate()``, one a mesh dim) through
:meth:`ShardingCtx.placements`, and ``constrain`` is
``DTensor.redistribute`` to them, the identity off a mesh (so the
one-device paths run unchanged) and on a tensor that is not a DTensor (a
rank's own shard inside ``local_map``).

Logical axes used across the zoo:
  batch    -> ("pod"?, "data")   activations' batch dim (pod only when the
                                  pod axis data-parallelizes)
  fsdp     -> ("data",)          the weights' second sharding axis (ZeRO-3)
  model    -> ("model",)          TP: heads / d_ff / vocab / experts
  seq      -> ()                  sequence
  kv_seq   -> ()                  sequence-sharded KV cache

Also here: the few collectives with a gradient that the explicit per-rank
paths (``local_map`` bodies: MoE's expert-parallel layer, the GNN lanes,
the row-sharded recsys tables) need, :func:`psum` and :func:`pmean` over
named mesh axes.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch

DEFAULT_RULES = {
    "batch": ("data",),
    "fsdp": ("data",),  # weight-sharding axis (ZeRO-3 style)
    "model": ("model",),
    "expert": ("model",),
    "seq": (),
    "kv_seq": (),
    "vocab": ("model",),
}


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a named ``DeviceMesh`` (the reference's
    ``mesh.shape``); {} for no mesh."""
    if mesh is None:
        return {}
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def spec_placements(mesh, spec) -> list:
    """DTensor placements over ``mesh`` of a spec (one entry a tensor dim:
    None, an axis name or a tuple of axis names): ``Shard(i)`` on each mesh
    dim named at tensor dim i, ``Replicate()`` on the others.  An axis
    named twice raises."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    seen = set()
    for i, entry in enumerate(spec):
        axes = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
        for a in axes:
            if a in seen:
                raise ValueError(f"spec {spec}: mesh axis {a!r} shards two dims")
            seen.add(a)
            out[names.index(a)] = Shard(i)
    return out


def flat_specs(tree, prefix: str = "") -> dict:
    """{leaf name: spec} of a spec tree (dicts, lists of layers; a spec is
    a tuple and a leaf), named as ``common.tree.flatten`` names params."""
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree) for k, v in flat_specs(tree[key],
                                                                   f"{prefix}{key}/").items()}
    if isinstance(tree, list):
        return {k: v for i, item in enumerate(tree) for k, v in flat_specs(item,
                                                                          f"{prefix}{i}/").items()}
    return {prefix[:-1]: tree}


@dataclasses.dataclass
class ShardingCtx:
    """Logical-axis -> mesh-axis mapping + constraint insertion."""

    mesh: Optional[object] = None  # a named torch DeviceMesh
    rules: dict = dataclasses.field(default_factory=lambda: dict(DEFAULT_RULES))
    #: inside a ``local_map`` body: {id(local table): (mesh, axes, first
    #: row)} for each table this rank holds a row shard of (the recsys
    #: lookups mask and sum over them)
    rows: dict = dataclasses.field(default_factory=dict)

    def spec(self, *logical) -> tuple:
        """The reference's PartitionSpec as a tuple: per dim None, one mesh
        axis, or a tuple of them (the rule's axes that the mesh has)."""
        shape = mesh_shape(self.mesh)
        parts = []
        for name in logical:
            if name is None:
                parts.append(None)
                continue
            axes = tuple(a for a in self.rules.get(name, ()) if a in shape)
            parts.append(None if not axes else axes[0] if len(axes) == 1 else axes)
        return tuple(parts)

    def placements(self, spec) -> Optional[list]:
        """``spec`` (from :meth:`spec` or a param-spec table) as DTensor
        placements on the mesh; None off a mesh."""
        if self.mesh is None:
            return None
        return spec_placements(self.mesh, spec)

    def constrain(self, x, *logical):
        """``x`` redistributed to the logical axes' placements when it is a
        DTensor on a mesh; otherwise ``x`` itself.  As JAX's
        ``with_sharding_constraint``, it constrains the gradient too: the
        cotangent arrives redistributed to the same placements (a partial
        sum is all-reduced there), where ``redistribute``'s backward alone
        would pass it on partial and leave a later product to gather its
        activations instead."""
        from torch.distributed.tensor import DTensor

        if self.mesh is None or not isinstance(x, DTensor):
            return x
        target = self.placements(self.spec(*logical))
        if list(x.placements) != target:
            x = x.redistribute(self.mesh, target)
        return DTensor.from_local(x.to_local(), self.mesh, target, shape=x.shape,
                                  stride=x.stride())

    def named(self, *logical) -> Optional[list]:
        """The placements of the logical axes (the reference's
        ``NamedSharding``); None off a mesh."""
        if self.mesh is None:
            return None
        return self.placements(self.spec(*logical))

    def axis_size(self, *axes) -> int:
        shape = mesh_shape(self.mesh)
        n = 1
        for a in axes:
            n *= shape.get(a, 1)
        return n


NULL_CTX = ShardingCtx(mesh=None)


@contextlib.contextmanager
def implicit_replication():
    """DTensor ops take plain tensors (positions, masks, the lr) as
    replicated: ``torch.distributed.tensor.experimental.
    implicit_replication``, made re-entrant (that one switches the flag off
    when any nested use exits, so a backward run after a nested forward
    would refuse the saved plain tensors)."""
    from torch.distributed.tensor import DTensor

    disp = DTensor._op_dispatcher
    prev = getattr(disp, "_allow_implicit_replication", False)
    disp._allow_implicit_replication = True
    try:
        yield
    finally:
        disp._allow_implicit_replication = prev


def batch_axes_with_pod(ctx: ShardingCtx) -> ShardingCtx:
    """A ctx whose 'batch' logical axis also spans the pod axis — used when
    the pod dimension data-parallelizes (default multi-pod mode)."""
    rules = dict(ctx.rules)
    rules["batch"] = ("pod", "data")
    return dataclasses.replace(ctx, rules=rules)


def shard_start(mesh, axes, n: int) -> int:
    """The first of this rank's rows when ``n`` rows are sharded over the
    named mesh ``axes`` in order (DTensor's ``Shard``: torch.chunk's split,
    ceil(n / k) rows a shard at each axis)."""
    start, size = 0, n
    for a in axes:
        size = -(-size // mesh.size(mesh.mesh_dim_names.index(a)))
        start += mesh.get_local_rank(a) * size
    return start


# ---------------------------------------------------------------------------
# collectives with a gradient, for the per-rank (local_map) bodies
# ---------------------------------------------------------------------------


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s: float):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


def scale_grad(x: torch.Tensor, s: float) -> torch.Tensor:
    """``x``, whose gradient is multiplied by ``s``: for a value that ``s``
    = 1 / n ranks compute alike and whose params' grads are summed over
    them."""
    return x if s == 1.0 else _ScaleGrad.apply(x, s)


def psum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The sum of ``x`` over the named mesh ``axes`` (one all-reduce an
    axis, ``torch.distributed.nn.functional.all_reduce``, which carries the
    gradient).  The result is the same on every rank of the axes, and so is
    its cotangent: the backward's all-reduce of it is divided by the ranks
    summed over, as JAX's ``shard_map`` divides the cotangent of an output
    replicated over an axis."""
    from torch.distributed.nn.functional import all_reduce

    for a in axes:
        n = mesh.size(mesh.mesh_dim_names.index(a))
        if n > 1:
            x = all_reduce(scale_grad(x, 1.0 / n), group=mesh.get_group(a))
    return x


def pmean(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The mean of ``x`` over the named mesh ``axes`` (:func:`psum` / n)."""
    n = 1
    for a in axes:
        n *= mesh.size(mesh.mesh_dim_names.index(a))
    return x if n == 1 else psum(x, mesh, axes) / n
